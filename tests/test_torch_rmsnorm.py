"""RMSNorm parity: the port's `rmsnorm` (a CPU tensor takes the plain
version) against the reference's Pallas kernel in interpret mode and its
jnp oracle, on the shapes of tests/test_kernels.py::test_rmsnorm_sweep.

Tolerances as in tests/test_kernels.py: TOL32 (rtol 2e-4, atol 2e-5) for
fp32, TOL (2e-2) for bf16, where the two frameworks round at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import ops as jops, ref as jref

from repro_torch.kernels.rmsnorm import ops

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("rows,d", [(8, 128), (16, 256), (9, 384)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("unit_offset", [False, True])
def test_rmsnorm_matches_reference(rows, d, dtype, unit_offset):
    rng = np.random.default_rng(rows * d)
    x = (rng.standard_normal((rows, d)) * 2).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    got = ops.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                      1e-5, unit_offset)
    assert got.dtype == tdt and got.shape == (rows, d)
    got = got.float().numpy()
    xj = jnp.asarray(x).astype(jdt)
    tol = TOL32 if dtype == "float32" else TOL
    for want in (jops.rmsnorm_pallas(xj, jnp.asarray(w), 1e-5, unit_offset,
                                     True),
                 jref.rmsnorm(xj, jnp.asarray(w), 1e-5, unit_offset)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def test_rmsnorm_keeps_leading_dims_and_weight_dtype():
    """qk-norm shape (B, S, H, hd) with the weight in the input dtype."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    got = ops.rmsnorm(torch.from_numpy(x).bfloat16(),
                      torch.from_numpy(w).bfloat16())
    want = jref.rmsnorm(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(w, jnp.bfloat16))
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


# The widths the card kernel holds a row in registers for, at an odd row
# count: the plain version (the card's oracle) against the reference (jitted:
# one compile a shape).
_rmsnorm_ref = jax.jit(jref.rmsnorm, static_argnums=(2, 3))


@pytest.mark.parametrize("d", [128, 2048, 4096, 7168])
@pytest.mark.parametrize("dtypes,unit_offset", [
    (("float32", "float32"), False), (("bfloat16", "bfloat16"), False),
    (("bfloat16", "float32"), True)])
def test_rmsnorm_model_widths_match_reference(d, dtypes, unit_offset):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((7, d)) * 2).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    (jx, tx), (jw, tw) = DTYPES[dtypes[0]], DTYPES[dtypes[1]]
    got = ops.rmsnorm(torch.from_numpy(x).to(tx), torch.from_numpy(w).to(tw),
                      1e-5, unit_offset)
    want = _rmsnorm_ref(jnp.asarray(x, jx), jnp.asarray(w, jw), 1e-5,
                        unit_offset)
    assert got.dtype == tx
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(TOL32 if dtypes[0] == "float32" else TOL))
