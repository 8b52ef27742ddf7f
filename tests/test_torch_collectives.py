"""FSDP collectives on two real ranks: two processes on gloo (CPU), each
with its own FileStore under the test's tmp_path, so parallel test workers
never share a rendezvous.

  * pack -> all-gather -> unpack returns every parameter whole on both
    ranks, and the gather's backward reduce-scatters the mean gradient;
  * one dp2 train step (each rank half the rows, ZeRO-3 shards of storage
    and moments) equals the dp1 step on the same global batch, at TOL32
    (rtol 2e-4, atol 2e-5): the two differ in summation order only.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import collectives as coll
from repro_torch.core.api import parallelize, shard_params, unshard_params
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import ParamMeta, named_leaves
from repro_torch.data.pipeline import DataConfig, SyntheticC4
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.train_step import default_schedule

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL32 = dict(rtol=2e-4, atol=2e-5)
B, S = 4, 16
DP2 = DistConfig(mesh_shape=(2, 1), param_dtype=torch.float32,
                 reorder=False)


def _spawn(fn, tmp_path, *args):
    mp.spawn(_worker, args=(fn, str(tmp_path), args), nprocs=2, join=True)


def _worker(rank, fn, tmp, args):
    store = dist.FileStore(f"{tmp}/store", 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        fn(rank, tmp, *args)
    finally:
        dist.destroy_process_group()


def _roundtrip(rank, tmp):
    metas = [ParamMeta("a", (3, 50)), ParamMeta("b", (7,), tp_dim=0),
             ParamMeta("c", (300,))]
    rng = np.random.default_rng(0)
    full = [torch.from_numpy(rng.standard_normal(m.global_shape)
                             .astype(np.float32)) for m in metas]
    shards = []
    for f, m in zip(full, metas):
        st = shard_params(f, m, DP2)
        c = m.chunk_len(DP2)
        shards.append(st[..., rank * c:(rank + 1) * c].contiguous()
                      .requires_grad_())
    g0 = coll.gathers
    outs = coll.gather_group(shards, metas, DP2)
    assert coll.gathers == g0 + 1
    for o, f in zip(outs, full):
        torch.testing.assert_close(o, f, rtol=0, atol=0)
    # each rank's cotangent is (rank + 1) * full: the mean is 1.5 * full
    grads = torch.autograd.grad(outs, shards, [(rank + 1) * f for f in full])
    for g, f, m in zip(grads, full, metas):
        c = m.chunk_len(DP2)
        want = shard_params(1.5 * f, m, DP2)[..., rank * c:(rank + 1) * c]
        torch.testing.assert_close(g, want, **TOL32)


def test_pack_gather_unpack_roundtrip(tmp_path):
    _spawn(_roundtrip, tmp_path)


def _train(dcfg, full, batch):
    """One train step from full params; returns logical (storage, v) and
    the metrics."""
    _, model = get_arch("qwen3_1_7b", smoke=True)
    par = parallelize(model, dcfg, ShapeConfig("t", S, B, "train"),
                      device="cpu")
    metas = model.metas(dcfg)
    storage = par.shard({k: shard_params(full[k], metas[k], dcfg)
                         for k in metas})
    opt = init_opt_state(storage)
    ocfg = AdamWConfig()
    step = par.train_step(ocfg, default_schedule(ocfg, 3, 0))
    storage, opt, m = step(storage, opt, batch)

    def logical(local):
        whole = par.unshard(local)
        return {k: unshard_params(whole[k], metas[k], dcfg) for k in whole}
    return logical(storage), logical(opt["v"]), \
        {k: float(v) for k, v in m.items()}


def _dp2_step(rank, tmp):
    data = torch.load(f"{tmp}/init.pt", weights_only=False)
    storage, v, metrics = _train(DP2, data["full"], data["batch"])
    if rank == 0:
        torch.save({"storage": storage, "v": v, "metrics": metrics},
                   f"{tmp}/dp2.pt")


def test_dp2_step_equals_dp1_step(tmp_path):
    _, model = get_arch("qwen3_1_7b", smoke=True)
    dp1 = DP2.with_(mesh_shape=(1, 1))
    full = model.init_full(torch.Generator().manual_seed(0), dp1, "cpu",
                           torch.float32)
    batch = SyntheticC4(DataConfig(vocab=model.cfg.vocab, seq_len=S,
                                   global_batch=B, seed=0)).batch(0)
    torch.save({"full": full, "batch": batch}, tmp_path / "init.pt")
    _spawn(_dp2_step, tmp_path)
    got = torch.load(tmp_path / "dp2.pt", weights_only=False)

    want_storage, want_v, want_metrics = _train(dp1, full, batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], want_metrics[k],
                                   err_msg=k, **TOL32)
    for tree, want in ((got["storage"], want_storage), (got["v"], want_v)):
        for (n, a), (_, b) in zip(named_leaves(tree), named_leaves(want)):
            torch.testing.assert_close(a, b, msg=n, **TOL32)
