"""The bucket+reorder prefetch stack (`core/stack.py`, reorder=True) of the
PyTorch port, on the CPU.

  * The reference's harness block model (`tests/dist_harness.py`: w1/b/w2
    TP-sharded-shaped, g and scale replicated, an aux l2 sum, a constant
    shift; D 8, H 16, B 16, L 4) on 2 gloo ranks, each on its own FileStore
    under the test's tmp_path: all 8 Table-6 flag combinations
    (ag_before_wait_fwd x ag_before_wait_bwd x rs_delay) with block
    buckets, and the per-param and two-bucket custom plans, against the
    dense single-process reference (loss, every parameter gradient, d/dx)
    and against the port's vanilla schedule, at the harness tolerances
    (rtol 2e-4, atol 2e-5).  The Table-6 flags change the order of work,
    never the values.
  * On the same 2 ranks, one block bucket's gradients (its TP-sharded and
    replicated params interleaved) through the port's quantized
    reduce-scatter (`pack_grad_bucket` + `finalize_grad_bucket`: fp8 and
    int8 stochastic round trips per class buffer, int8 over the bf16 wire
    of grad_compression) equal the reference's `finalize_grad_bucket` bit
    for bit, its reduce-scatter summing the ranks' round-tripped buffers.
  * qwen3 smoke at one rank: loss and every gradient at TOL32 against the
    JAX reference's reorder=True loss step; per-segment remat policies and
    segment_prefetch=False give the vanilla schedule's values; the
    collectives per step (every bucket gathered twice, reduce-scattered
    once).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import api as japi
from repro.core import collectives as jcoll
from repro.core.dist import DistConfig as JDistConfig
from repro.core.dist import single_device_config as jax_single_device_config
from repro.core.meta import ParamMeta as JParamMeta
from repro.data.pipeline import DataConfig, SyntheticC4
from repro.models import runtime as JRT
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch

from repro_torch.core import api
from repro_torch.core import collectives as coll
from repro_torch.core.api import shard_params, unshard_params
from repro_torch.core.bucketing import (BucketPlan, per_param_plan,
                                        whole_block_plan)
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import ParamMeta, named_leaves
from repro_torch.core.stack import apply_stack
from repro_torch.models import runtime as RT
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL32 = dict(rtol=2e-4, atol=2e-5)
D, H, B, L = 8, 16, 16, 4
DP = 2
FLAGS = list(itertools.product((True, False), repeat=3))
CUSTOM = BucketPlan((("b", "w1"), ("g", "scale", "w2")))
CASES = ([f"agf={f}/agb={b}/rsd={r}" for f, b, r in FLAGS]
         + ["bucket=none", "bucket=custom2"])


def block_metas():
    return {"w1": ParamMeta("w1", (D, H), tp_dim=1),
            "b": ParamMeta("b", (H,), tp_dim=0),
            "g": ParamMeta("g", (1,)),
            "w2": ParamMeta("w2", (H, D), tp_dim=0),
            "scale": ParamMeta("scale", (D,))}


def block_fn(p, consts, x):
    h = torch.tanh(x @ p["w1"])
    h = h * p["g"][0] + p["b"]
    y = x + (h @ p["w2"]) * p["scale"] + consts["shift"]
    return y, {"l2": torch.sum(h ** 2)}


def _init():
    rng = np.random.default_rng(0)
    full = {"w1": rng.standard_normal((L, D, H)) * 0.3,
            "b": rng.standard_normal((L, H)) * 0.1,
            "g": np.full((L, 1), 0.7),
            "w2": rng.standard_normal((L, H, D)) * 0.3,
            "scale": 1.0 + rng.standard_normal((L, D)) * 0.1}
    full = {k: torch.from_numpy(v.astype(np.float32)) for k, v in full.items()}
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    return full, x, {"shift": torch.full((D,), 0.01)}


def _cfg(case: str) -> tuple[DistConfig, BucketPlan]:
    cfg = DistConfig(mesh_shape=(DP, 1), param_dtype=torch.float32)
    metas = block_metas()
    if case == "vanilla":
        return cfg.with_(reorder=False), whole_block_plan(metas)
    if case == "bucket=none":
        return cfg, per_param_plan(metas)
    if case == "bucket=custom2":
        return cfg, CUSTOM
    f, b, r = FLAGS[CASES.index(case)]
    return cfg.with_(ag_before_wait_fwd=f, ag_before_wait_bwd=b,
                     rs_delay=r), whole_block_plan(metas)


def _run_case(rank, case, full, x, consts):
    """This rank's (global loss, full parameter grads, d(local loss)/dx)."""
    cfg, plan = _cfg(case)
    metas = block_metas()
    storage = {}
    for k, m in metas.items():
        st = shard_params(full[k], m, cfg)
        c = m.chunk_len(cfg)
        storage[k] = st[..., rank * c:(rank + 1) * c].contiguous() \
            .requires_grad_()
    rows = B // DP
    xl = x[rank * rows:(rank + 1) * rows].clone().requires_grad_()
    y, aux = apply_stack(block_fn, metas, cfg, storage, consts, xl,
                         plan=plan)
    loss = torch.mean(y ** 2) + 1e-3 * aux["l2"]
    grads = torch.autograd.grad(loss, [storage[k] for k in metas] + [xl])
    out = loss.detach().clone()
    dist.all_reduce(out)
    whole = {}
    for k, g in zip(metas, grads):
        parts = [torch.empty_like(g) for _ in range(DP)]
        dist.all_gather(parts, g.contiguous())
        whole[k] = unshard_params(torch.cat(parts, dim=-1), metas[k], cfg)
    return float(out) / DP, whole, grads[-1]


QUANT_CASES = {"fp8": ("fp8", {}), "int8": ("int8", {}),
               "int8+gc": ("int8", dict(grad_compression=True))}


def _bucket_grads(rank):
    """This rank's full gradients of the block bucket, from a seed per
    rank."""
    rng = np.random.default_rng(100 + rank)
    return [rng.standard_normal(m.global_shape).astype(np.float32)
            for m in block_metas().values()]


def _quant_cfg(case, config=DistConfig, dtype=torch.float32):
    precision, kw = QUANT_CASES[case]
    return config(mesh_shape=(DP, 1), param_dtype=dtype,
                  comm_precision=precision, **kw)


def _grad_bucket(rank, case):
    """This rank's local gradient chunks of the bucket after the port's
    quantized reduce-scatter."""
    cfg = _quant_cfg(case)
    metas = list(block_metas().values())
    ct = coll.pack_grad_bucket([torch.from_numpy(g)
                                for g in _bucket_grads(rank)], metas, cfg)
    return coll.finalize_grad_bucket(
        ct, metas, cfg, [m.shard_shape(cfg) for m in metas]).wait()


def _worker(rank, tmp):
    torch.set_num_threads(1)   # tiny tensors; spare the test workers' cores
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", DP),
                            rank=rank, world_size=DP)
    try:
        full, x, consts = _init()
        res = {c: _run_case(rank, c, full, x, consts)
               for c in ["vanilla", *CASES]}
        res.update({f"grad_bucket/{c}": _grad_bucket(rank, c)
                    for c in QUANT_CASES})
        torch.save(res, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prefetch")
    mp.spawn(_worker, args=(str(tmp),), nprocs=DP, join=True)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(DP)]


@functools.cache
def _dense_reference():
    """Loss, parameter grads and d/dx of the global objective: the mean of
    the ranks' local losses = mean(y^2) + 1e-3 * sum(l2) / DP."""
    full, x, consts = _init()
    full = {k: v.clone().requires_grad_() for k, v in full.items()}
    x = x.clone().requires_grad_()
    y, l2 = x, 0.0
    for i in range(L):
        y, aux = block_fn({k: v[i] for k, v in full.items()}, consts, y)
        l2 = l2 + aux["l2"]
    loss = torch.mean(y ** 2) + 1e-3 * l2 / DP
    grads = torch.autograd.grad(loss, list(full.values()) + [x])
    return float(loss.detach()), dict(zip(full, grads[:-1])), grads[-1]


@pytest.mark.parametrize("case", CASES)
def test_prefetch_matches_dense_reference_and_vanilla(two_ranks, case):
    ref_loss, ref_grads, ref_dx = _dense_reference()
    rows = B // DP
    for rank, res in enumerate(two_ranks):
        loss, grads, dx = res[case]
        v_loss, v_grads, v_dx = res["vanilla"]
        np.testing.assert_allclose(loss, ref_loss, rtol=2e-5)
        np.testing.assert_allclose(loss, v_loss, rtol=2e-5)
        # d(local loss)/d(local x) is DP x the dense d(global mean)/dx
        want_dx = ref_dx[rank * rows:(rank + 1) * rows] * DP
        torch.testing.assert_close(dx, want_dx, **TOL32)
        torch.testing.assert_close(dx, v_dx, **TOL32)
        for k in ref_grads:
            torch.testing.assert_close(grads[k], ref_grads[k], msg=k,
                                       **TOL32)
            torch.testing.assert_close(grads[k], v_grads[k], msg=k, **TOL32)


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantized_grad_bucket_on_two_ranks_is_bit_equal_to_reference(
        two_ranks, case, monkeypatch):
    """The reference's `finalize_grad_bucket` per rank, its reduce-scatter
    (a psum_scatter under shard_map) replaced by the sum of the ranks'
    round-tripped class buffers, which the first pass captures."""
    jcfg = _quant_cfg(case, JDistConfig, jnp.float32)
    jmetas = [JParamMeta(m.name, m.global_shape, m.tp_dim)
              for m in block_metas().values()]
    shapes = [m.shard_shape(jcfg) for m in jmetas]
    assert len(jcoll._vma_classes(jmetas)) == 2

    def finalize(rank):
        cts = jcoll.pack_grad_bucket(
            [jnp.asarray(g) for g in _bucket_grads(rank)], jmetas, jcfg)
        return jcoll.finalize_grad_bucket(cts, jmetas, jcfg, shapes)
    wire = [[] for _ in range(DP)]
    for r in range(DP):
        monkeypatch.setattr(jcoll, "reduce_scatter_flat",
                            lambda ct, cfg, r=r: wire[r].append(ct) or ct[0])
        finalize(r)
    for r in range(DP):
        cls = iter(range(len(wire[0])))
        monkeypatch.setattr(
            jcoll, "reduce_scatter_flat",
            lambda ct, cfg, r=r: (lambda c: wire[0][c][r] + wire[1][c][r])(
                next(cls)))
        want = finalize(r)
        got = two_ranks[r][f"grad_bucket/{case}"]
        assert len(got) == len(want)
        for m, a, b in zip(jmetas, got, want):
            assert tuple(a.shape) == tuple(b.shape), m.name
            np.testing.assert_array_equal(
                a.numpy().view(np.uint32), np.asarray(b).view(np.uint32),
                err_msg=m.name)


# ---------------------------------------------------------------------------
# qwen3 smoke at one rank
# ---------------------------------------------------------------------------
BS, SS, ARCH = 4, 16, "qwen3_1_7b"


@functools.cache
def _jax_reorder_step():
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = jax_single_device_config(param_dtype=jnp.float32,
                                    reduce_dtype=jnp.float32, reorder=True)
    storage = JRT.init_storage(jmodel, jax.random.PRNGKey(0), dcfg)
    batch = SyntheticC4(DataConfig(vocab=jcfg.vocab, seq_len=SS,
                                   global_batch=BS, seed=0)).batch(0)
    par = japi.parallelize(jmodel, dcfg, JShapeConfig("t", SS, BS, "train"))
    loss, grads = par.loss_step()(storage, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(storage), batch, float(loss), to_np(grads)


def _port_step(**kw):
    storage_np, batch, _, _ = _jax_reorder_step()
    _, model = get_arch(ARCH, smoke=True)
    dcfg = DistConfig(param_dtype=torch.float32, **kw)
    par = api.parallelize(model, dcfg, ShapeConfig("t", SS, BS, "train"),
                          device="cpu")
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    loss, grads = par.loss_step()(storage, batch)
    return par, float(loss), grads


def test_qwen3_prefetch_step_matches_reference():
    _, _, want_loss, want_grads = _jax_reorder_step()
    par, loss, grads = _port_step()
    assert par.dcfg.reorder and par.plan.dcfg.segment_prefetch
    np.testing.assert_allclose(loss, want_loss, **TOL32)
    got, want = named_leaves(grads), named_leaves(want_grads)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=n, **TOL32)


@pytest.mark.parametrize("kw", [
    dict(remat="full"), dict(remat="save_dots"),
    dict(remat="attn=full,mlp=fsdp_only"), dict(remat="none"),
    dict(segment_prefetch=False, remat="attn=save_dots,mlp=none"),
    dict(bucket_mode="none", rs_delay=False)],
    ids=["full", "save_dots", "vector", "none", "unsegmented-vector",
         "per-param-no-rs-delay"])
def test_qwen3_prefetch_policies_keep_the_values(kw):
    _, want_loss, want = _port_step(reorder=False, **{
        k: v for k, v in kw.items() if k == "bucket_mode"})
    _, loss, grads = _port_step(**kw)
    np.testing.assert_allclose(loss, want_loss, **TOL32)
    for (n, a), (_, b) in zip(named_leaves(grads), named_leaves(want)):
        torch.testing.assert_close(a, b, msg=n, **TOL32)


@pytest.mark.parametrize("bucket_mode", ["none", "block"])
def test_qwen3_prefetch_collective_counts(bucket_mode):
    """Per loss step: every (segment-split) bucket of every layer is
    gathered once forward and once backward and reduce-scattered once;
    the embedding, final norm and tied head add one of each."""
    _, model = get_arch(ARCH, smoke=True)
    metas = model.block_metas(DistConfig())
    g0, r0 = coll.gathers, coll.reduce_scatters
    par, _, _ = _port_step(bucket_mode=bucket_mode)
    n = len(par.plan.bucket_plan("blocks").index_groups(metas))
    per_layer = n if bucket_mode == "none" else 2   # block: attn | mlp
    buckets = per_layer * model.n_steps
    assert coll.gathers - g0 == 2 * buckets + 3
    assert coll.reduce_scatters - r0 == buckets + 3
