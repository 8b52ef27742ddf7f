"""AdamW parity: the port's plain version (the CPU path of
`repro_torch.kernels.adamw.ops`, which updates in place) against the
reference's plain version and its Pallas kernel in interpret mode, at the
sizes of tests/test_kernels.py's `test_adamw_sweep`, and the port's
optimizer step (global-norm clipping, weight decay on every leaf, device
scalars) against the reference's `apply_adamw`.

Inputs come from numpy with one seed; everything is fp32 and held at TOL32
(rtol 2e-4, atol 2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dist import single_device_config as jax_single_device_config
from repro.kernels.adamw import ops as jops, ref as jref
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule

from repro_torch.core.dist import DistConfig, make_mesh
from repro_torch.kernels.adamw import ops, ref
from repro_torch.optim import adamw
from repro_torch.optim import schedule

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL32 = dict(rtol=2e-4, atol=2e-5)
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)


def _state(n, seed=0):
    rng = np.random.default_rng(seed)
    p, g = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    m = (rng.standard_normal(n) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("n", [1024, 5000])
@pytest.mark.parametrize("t", [1, 3])
def test_adamw_matches_reference_and_kernel(n, t):
    p, g, m, v = _state(n)
    jkw = dict(lr=1e-3, t=jnp.asarray(t), **HYPER)
    want = jref.adamw_update(*map(jnp.asarray, (p, g, m, v)), **jkw)
    kern = jops.adamw_update_pallas(*map(jnp.asarray, (p, g, m, v)),
                                    interpret=True, **jkw)
    tp, tg, tm, tv = map(torch.from_numpy, (p.copy(), g, m.copy(), v.copy()))
    ops.adamw_update(tp, tg, tm, tv, lr=torch.tensor(1e-3),
                     t=torch.tensor(t, dtype=torch.int32),
                     scale=torch.tensor(1.0), **HYPER)
    for got, a, b in zip((tp, tm, tv), want, kern):
        np.testing.assert_allclose(got.numpy(), np.asarray(a), **TOL32)
        np.testing.assert_allclose(got.numpy(), np.asarray(b), **TOL32)
    for a in (want[0], kern[0]):        # the update itself, p_new - p
        np.testing.assert_allclose(tp.numpy() - p, np.asarray(a) - p, **TOL32)


@pytest.mark.parametrize("n", [1024, 5000])
def test_adamw_weight_decay_matches_reference_and_kernel(n):
    """lr 1e-2, wd 1: a missing decay would move the update p_new - p by
    1e-2*|p|, far outside TOL32 (at lr 1e-3, wd 0.1 it would hide inside
    the tolerance on p_new itself)."""
    p, g, m, v = _state(n, seed=4)
    hyper = dict(HYPER, wd=1.0)
    jkw = dict(lr=1e-2, t=jnp.asarray(3), **hyper)
    want = jref.adamw_update(*map(jnp.asarray, (p, g, m, v)), **jkw)[0]
    kern = jops.adamw_update_pallas(*map(jnp.asarray, (p, g, m, v)),
                                    interpret=True, **jkw)[0]
    no_decay = jref.adamw_update(*map(jnp.asarray, (p, g, m, v)),
                                 **dict(jkw, wd=0.0))[0]
    assert not np.allclose(np.asarray(no_decay) - p, np.asarray(want) - p,
                           **TOL32)
    tp, tg, tm, tv = map(torch.from_numpy, (p.copy(), g, m.copy(), v.copy()))
    ops.adamw_update(tp, tg, tm, tv, lr=torch.tensor(1e-2),
                     t=torch.tensor(3, dtype=torch.int32),
                     scale=torch.tensor(1.0), **hyper)
    for a in (want, kern):
        np.testing.assert_allclose(tp.numpy() - p, np.asarray(a) - p, **TOL32)


def test_clip_scale_is_folded_into_the_gradient():
    p, g, m, v = _state(777, seed=1)
    kw = dict(lr=torch.tensor(3e-4), t=torch.tensor(2, dtype=torch.int32),
              **HYPER)
    a = ref.adamw_update(*map(torch.from_numpy, (p, g, m, v)),
                         scale=torch.tensor(0.25), **kw)
    b = ref.adamw_update(*map(torch.from_numpy, (p, g * 0.25, m, v)),
                         scale=torch.tensor(1.0), **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, **TOL32)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_optimizer_step_matches_reference(clip):
    """Two leaves (one stacked), global norm over both, clipping at
    `grad_clip` (off when 0), then the update at step 5."""
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((3, 256)).astype(np.float32),
            "b": rng.standard_normal(384).astype(np.float32)}
    grads = {k: (rng.standard_normal(a.shape) * 2).astype(np.float32)
             for k, a in tree.items()}
    mom = {k: (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
           for k, a in tree.items()}
    vel = {k: (np.abs(rng.standard_normal(a.shape)) * 0.01)
           .astype(np.float32) for k, a in tree.items()}
    sched = dict(peak_lr=3e-4, warmup=3, total=10)

    jcfg = jax_single_device_config()
    jstate = {"m": {k: jnp.asarray(a) for k, a in mom.items()},
              "v": {k: jnp.asarray(a) for k, a in vel.items()},
              "step": jnp.asarray(4, jnp.int32)}
    jlr = jschedule.warmup_cosine(jstate["step"], **sched)
    from jax.sharding import PartitionSpec as P
    from repro.core.compat import shard_map
    from repro.core.dist import make_mesh as jax_make_mesh
    from repro.core.meta import ParamMeta
    metas = {k: ParamMeta(k, a.shape) for k, a in tree.items()}
    ocfg_j = jadamw.AdamWConfig(grad_clip=clip)

    def step(s, gr, st):
        return jadamw.apply_adamw(s, gr, st, metas, jcfg, ocfg_j, jlr)
    specs = ({k: P() for k in tree}, {k: P() for k in tree},
             {"m": {k: P() for k in tree}, "v": {k: P() for k in tree},
              "step": P()})
    want_p, want_s, want_norm = shard_map(
        step, mesh=jax_make_mesh(jcfg), in_specs=specs,
        out_specs=(specs[0], specs[2], P()))(
        {k: jnp.asarray(a) for k, a in tree.items()},
        {k: jnp.asarray(a) for k, a in grads.items()}, jstate)

    dcfg = DistConfig(param_dtype=torch.float32)
    make_mesh(dcfg)
    storage = {k: torch.from_numpy(a.copy()) for k, a in tree.items()}
    state = {"m": {k: torch.from_numpy(a.copy()) for k, a in mom.items()},
             "v": {k: torch.from_numpy(a.copy()) for k, a in vel.items()},
             "step": torch.tensor(4, dtype=torch.int32)}
    lr = schedule.warmup_cosine(state["step"], **sched)
    np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), rtol=1e-6)
    norm = adamw.apply_adamw(
        storage, {k: torch.from_numpy(a) for k, a in grads.items()}, state,
        dcfg, adamw.AdamWConfig(grad_clip=clip), lr)
    np.testing.assert_allclose(norm.numpy(), np.asarray(want_norm), **TOL32)
    assert int(state["step"]) == int(want_s["step"]) == 5
    for k in tree:
        np.testing.assert_allclose(storage[k].numpy(),
                                   np.asarray(want_p[k]), **TOL32)
        for s in ("m", "v"):
            np.testing.assert_allclose(state[s][k].numpy(),
                                       np.asarray(want_s[s][k]), **TOL32)


@pytest.mark.parametrize("step", [0, 2, 5, 9, 20])
def test_schedule_matches_reference(step):
    kw = dict(peak_lr=1e-3, warmup=5, total=12)
    want = jschedule.warmup_cosine(jnp.asarray(step, jnp.int32), **kw)
    got = schedule.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
