"""Cross-entropy parity: the port's plain version (the CPU path of
`repro_torch.kernels.cross_entropy.ops`) against the reference's plain
version and its Pallas kernels run in interpret mode, at the shapes of
tests/test_kernels.py's `test_xent_sweep` (V not a multiple of 2048).

Inputs come from numpy with one seed.  Loss, lse and dlogits are held at
TOL32 (rtol 2e-4, atol 2e-5) against the reference's plain version (both
fp32 on the CPU, differing only in summation order) and at the reference
test's own tolerance against the interpret-mode kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cross_entropy import ops as jops, ref as jref

from repro_torch.kernels.cross_entropy import ops, ref

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL32 = dict(rtol=2e-4, atol=2e-5)


def _inputs(R, V, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((R, V)) * 2).astype(np.float32)
    targets = rng.integers(0, V, R).astype(np.int32)
    g = rng.standard_normal(R).astype(np.float32)
    return logits, targets, g


@pytest.mark.parametrize("R,V", [(16, 1000), (24, 5003), (8, 2048)])
def test_xent_matches_reference(R, V):
    logits, targets, g = _inputs(R, V)
    want_loss, want_lse = jref.xent(jnp.asarray(logits), jnp.asarray(targets))
    want_dx = jref.dlogits(jnp.asarray(logits), jnp.asarray(targets),
                           want_lse, jnp.asarray(g))
    kern = jops.fused_xent(jnp.asarray(logits), jnp.asarray(targets), True)

    x = torch.from_numpy(logits)
    t = torch.from_numpy(targets)
    loss, lse = ref.xent(x, t)
    dx = ref.dlogits(x, t, lse, torch.from_numpy(g))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL32)
    # each row over |g| (softmax - onehot), so every softmax term meets
    # the tolerance at its own size
    ag = np.abs(g)[:, None]
    np.testing.assert_allclose(dx.numpy() / ag, np.asarray(want_dx) / ag,
                               **TOL32)
    np.testing.assert_allclose(loss.numpy(), np.asarray(kern),
                               rtol=2e-3, atol=2e-3)


def test_xent_autograd_matches_reference_kernel_gradient():
    """The op's autograd.Function (CPU: plain forward and backward) against
    the gradient of the reference's fused op in interpret mode."""
    import jax
    logits, targets, g = _inputs(9, 5000, seed=1)
    want = jax.grad(lambda l: (jops.fused_xent(l, jnp.asarray(targets), True)
                               * jnp.asarray(g)).sum())(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss = ops.xent(x, torch.from_numpy(targets).long())
    (dx,) = torch.autograd.grad(loss, x, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-4)


def test_xent_bf16_logits_keep_their_dtype():
    logits, targets, g = _inputs(8, 300, seed=2)
    x = torch.from_numpy(logits).bfloat16()
    t = torch.from_numpy(targets)
    loss, lse = ref.xent(x, t)
    assert loss.dtype == lse.dtype == torch.float32
    dx = ref.dlogits(x, t, lse, torch.from_numpy(g))
    assert dx.dtype == torch.bfloat16
    want, _ = jref.xent(jnp.asarray(x.float().numpy()), jnp.asarray(targets))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want), **TOL32)


def test_out_of_range_target_adds_no_target_logit():
    """As the TPU kernel's `col == t` test: no target logit, no one-hot."""
    logits, _, g = _inputs(3, 50, seed=3)
    x = torch.from_numpy(logits)
    t = torch.tensor([50, -1, 7])
    loss, lse = ref.xent(x, t)
    torch.testing.assert_close(loss[:2], lse[:2])
    dx = ref.dlogits(x, t, lse, torch.from_numpy(g))
    p = torch.softmax(x, -1) * torch.from_numpy(g)[:, None]
    torch.testing.assert_close(dx[:2], p[:2], **TOL32)
