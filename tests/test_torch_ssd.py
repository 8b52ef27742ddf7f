"""The port's Mamba-2 SSD chunk scan against the JAX reference on the CPU.

  * the plain version (`repro_torch/kernels/ssd/ref.ssd_chunked`), y and
    the final state S, against JAX's `ref.ssd_chunked` and against JAX's
    Pallas kernel in interpret mode (`ops.ssd(..., interpret=True)`), at
    the `test_ssd_sweep` shapes plus the zamba2 smoke shape with T = 24 and
    chunk 16 (a ragged last chunk), at the reference's own tolerance
    (rtol 1e-4, atol 1e-4);
  * chunk invariance, as `test_ssd_chunk_invariance`;
  * the gradients of the port's `ssd` autograd.Function (dx, ddt, dA, dB,
    dC, dD) against `jax.vjp` of JAX's `ref.ssd_chunked` at TOL32.  dA and
    dD are per-head sums of B*T*P terms that cancel (|dA| of 0.07 from
    terms of size ~5), so fp32 summation order moves them by ~1e-4 in
    absolute terms: they are held at TOL32 after division by the largest
    |value| of their array (`_close`);
  * where the decay across a chunk overflows exp in the reference's masked
    upper triangle, the reference's dt and A gradients are NaN and the
    port's are finite and equal the reference's at a chunk short enough
    not to overflow;
  * a CPU call never reaches the kernel build;
  * the chunk-parallel plain versions that the CUDA kernels compute:
    `ssd_chunk_states` (the state entering each chunk and the final state)
    against JAX's `ref.ssd_chunked` at TOL_REF, and `ssd_chunked_bwd` (the
    explicit reverse-pass backward) against `jax.vjp` of JAX's
    `ref.ssd_chunked` at TOL32 (dA and dD scaled as above) and against
    autograd through the port's `ref.ssd_chunked`, finite where the
    reference's gradient overflows; dropping its reverse state pass must
    fail that check.

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ops, ref

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL_REF = dict(rtol=1e-4, atol=1e-4)
TOL32 = dict(rtol=2e-4, atol=2e-5)
SHAPES = [  # T, H, P, G, N, chunk
    (96, 4, 16, 2, 8, 32), (128, 2, 32, 1, 16, 64), (64, 4, 16, 4, 8, 64),
    (24, 8, 16, 1, 8, 16),
]


def _inputs(T, H, P, G, N, seed=0, B=2, decay=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, T, H)), 0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * decay)).astype(np.float32)
    Bm = (rng.standard_normal((B, T, G, N)) * 0.4).astype(np.float32)
    Cm = (rng.standard_normal((B, T, G, N)) * 0.4).astype(np.float32)
    D = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _torch(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _jax_vjp(arrays, ct, chunk):
    _, vjp = jax.vjp(lambda *a: jref.ssd_chunked(*a, chunk=chunk)[0],
                     *map(jnp.asarray, arrays))
    return [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _close(name, a, b, scale_all=False, **tol):
    """TOL32 on every gradient; the per-head reductions dA and dD (every
    array when `scale_all`) relative to their array's scale (see the module
    docstring)."""
    scale = max(1.0, float(np.abs(b).max())) \
        if scale_all or name in ("dA", "dD") else 1.0
    np.testing.assert_allclose(a / scale, b / scale, err_msg=name, **tol)


def _port_grads(arrays, ct, chunk):
    ins = _torch(arrays, grad=True)
    y = ops.ssd(*ins, chunk=chunk)
    return [g.numpy() for g in torch.autograd.grad(y, ins,
                                                   torch.from_numpy(ct))]


@pytest.mark.parametrize("T,H,P,G,N,chunk", SHAPES)
def test_plain_ssd_matches_reference(T, H, P, G, N, chunk):
    x, dt, A, Bm, Cm, D = _inputs(T, H, P, G, N)
    want_y, want_s = jref.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                      D=jnp.asarray(D), chunk=chunk)
    kernel_y = jops.ssd(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)), chunk,
                        True)
    y, s = ref.ssd_chunked(*_torch((x, dt, A, Bm, Cm)),
                           D=torch.from_numpy(D), chunk=chunk)
    assert y.shape == (2, T, H, P) and s.shape == (2, H, P, N)
    assert y.dtype == s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL_REF)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL_REF)
    np.testing.assert_allclose(y.numpy(), np.asarray(kernel_y), **TOL_REF)
    # the autograd.Function's forward is the plain version on the CPU
    np.testing.assert_array_equal(
        ops.ssd(*_torch((x, dt, A, Bm, Cm, D)), chunk=chunk).numpy(),
        y.numpy())


def test_plain_ssd_carries_a_given_state_like_the_reference():
    x, dt, A, Bm, Cm, D = _inputs(40, 4, 16, 2, 8, seed=3)
    s0 = np.random.default_rng(4).standard_normal((2, 4, 16, 8)).astype(
        np.float32)
    want_y, want_s = jref.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                      D=None, chunk=16,
                                      state=jnp.asarray(s0))
    y, s = ref.ssd_chunked(*_torch((x, dt, A, Bm, Cm)), chunk=16,
                           state=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL_REF)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL_REF)


def test_ssd_chunk_invariance():
    """Chunk size is an implementation detail: results must not change."""
    x, dt, A, Bm, Cm, _ = _inputs(128, 2, 8, 1, 4, seed=7, B=1)
    ins = _torch((x, dt, A, Bm, Cm))
    y1, s1 = ref.ssd_chunked(*ins, chunk=16)
    y2, s2 = ref.ssd_chunked(*ins, chunk=128)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T,H,P,G,N,chunk", SHAPES)
def test_ssd_gradients_match_reference_vjp(T, H, P, G, N, chunk):
    arrays = _inputs(T, H, P, G, N, seed=1)
    ct = np.random.default_rng(2).standard_normal(arrays[0].shape).astype(
        np.float32)
    want = _jax_vjp(arrays, ct, chunk)
    got = _port_grads(arrays, ct, chunk)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert a.shape == b.shape, name
        _close(name, a, b, **TOL32)


def test_ssd_gradients_stay_finite_where_the_reference_overflows():
    """Decay of ~4 a step over a 128-long chunk: exp of the reference's
    masked upper triangle overflows and its VJP turns the dt and A
    gradients into NaN.  The port masks before exp; its gradients equal
    the reference's at chunk 8, where nothing overflows."""
    arrays = list(_inputs(128, 2, 16, 1, 8, seed=5, B=1))
    arrays[2] = np.array([-4.0, -0.5], np.float32)          # A
    ct = np.random.default_rng(6).standard_normal(arrays[0].shape).astype(
        np.float32)
    broken = _jax_vjp(arrays, ct, 128)
    assert not np.isfinite(broken[1]).all() and not np.isfinite(
        broken[2]).all()
    want = _jax_vjp(arrays, ct, 8)
    got = _port_grads(arrays, ct, 128)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert np.isfinite(a).all(), name
        _close(name, a, b, scale_all=True, **TOL32)


def test_cpu_ssd_never_touches_the_kernel_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel build was reached from the CPU")
    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "build", refuse)
    before = ops.launches
    ins = _torch(_inputs(24, 4, 16, 1, 8), grad=True)
    y = ops.ssd(*ins, chunk=16)
    y.sum().backward()
    assert all(t.grad is not None for t in ins)
    assert ops.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_cuda(*ins)


GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


@pytest.mark.parametrize("T,H,P,G,N,chunk", SHAPES)
def test_chunk_states_match_reference(T, H, P, G, N, chunk):
    """The final state against JAX's; the state entering chunk c against
    JAX's final state of the first c chunks."""
    x, dt, A, Bm, Cm, _ = _inputs(T, H, P, G, N, seed=8)
    states, final = ref.ssd_chunk_states(*_torch((x, dt, A, Bm, Cm)),
                                         chunk=chunk)
    nC = -(-T // chunk)
    assert states.shape == (2, H, nC, P, N) and final.dtype == torch.float32
    _, want = jref.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                               chunk=chunk)
    np.testing.assert_allclose(final.numpy(), np.asarray(want), **TOL_REF)
    assert not states[:, :, 0].any()
    c = nC - 1
    if c == 0:
        return
    _, want = jref.ssd_chunked(*(jnp.asarray(a[:, :c * chunk])
                                 for a in (x, dt)), jnp.asarray(A),
                               *(jnp.asarray(a[:, :c * chunk])
                                 for a in (Bm, Cm)), chunk=chunk)
    np.testing.assert_allclose(states[:, :, c].numpy(), np.asarray(want),
                               **TOL_REF)


def _explicit_grads(arrays, ct, chunk):
    out = ref.ssd_chunked_bwd(*_torch(arrays), torch.from_numpy(ct),
                              chunk=chunk)
    return [g.numpy() for g in out]


@pytest.mark.parametrize("T,H,P,G,N,chunk", SHAPES)
def test_explicit_backward_matches_reference_vjp(T, H, P, G, N, chunk):
    arrays = _inputs(T, H, P, G, N, seed=1)
    ct = np.random.default_rng(2).standard_normal(arrays[0].shape).astype(
        np.float32)
    got = _explicit_grads(arrays, ct, chunk)
    for name, a, b in zip(GRADS, got, _jax_vjp(arrays, ct, chunk)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _close(name, a, b, **TOL32)
    ins = _torch(arrays, grad=True)
    want = torch.autograd.grad(ref.ssd_chunked(*ins, chunk=chunk)[0], ins,
                               torch.from_numpy(ct))
    for name, a, b in zip(GRADS, got, want):
        _close(name, a, b.numpy(), **TOL32)


def test_explicit_backward_stays_finite_where_the_reference_overflows():
    """As the autograd.Function's case above: finite at chunk 128, equal to
    JAX's gradient at chunk 8."""
    arrays = list(_inputs(128, 2, 16, 1, 8, seed=5, B=1))
    arrays[2] = np.array([-4.0, -0.5], np.float32)          # A
    ct = np.random.default_rng(6).standard_normal(arrays[0].shape).astype(
        np.float32)
    got = _explicit_grads(arrays, ct, 128)
    for name, a, b in zip(GRADS, got, _jax_vjp(arrays, ct, 8)):
        assert np.isfinite(a).all(), name
        _close(name, a, b, scale_all=True, **TOL32)


def test_explicit_backward_needs_its_reverse_state_pass():
    """The chunk grads with the state gradient leaving every chunk dropped
    (dS_out = 0) must fail the check the full backward passes."""
    arrays = _inputs(96, 4, 16, 2, 8, seed=1)
    ct = np.random.default_rng(2).standard_normal(arrays[0].shape).astype(
        np.float32)
    ins = _torch(arrays)
    states, _ = ref.ssd_chunk_states(*ins[:5], chunk=32)
    dstates = ref.ssd_chunk_dstates(torch.from_numpy(ct), ins[1], ins[2],
                                    ins[4], chunk=32)
    assert dstates[:, :, :-1].abs().max() > 0 and not dstates[:, :, -1].any()
    dropped = ref.ssd_chunk_grads(*ins, torch.from_numpy(ct), states,
                                  torch.zeros_like(dstates), chunk=32)
    want = _jax_vjp(arrays, ct, 32)
    for name in ("dx", "ddt", "dB"):
        i = GRADS.index(name)
        with pytest.raises(AssertionError):
            _close(name, dropped[i].numpy(), want[i], **TOL32)


def test_grad_terms_bound_every_gradient():
    arrays = _inputs(96, 4, 16, 2, 8, seed=3)
    ct = np.random.default_rng(4).standard_normal(arrays[0].shape).astype(
        np.float32)
    ins = _torch(arrays)
    grads = ref.ssd_chunked_bwd(*ins, torch.from_numpy(ct), chunk=32)
    terms = ref.ssd_grad_terms(*ins, torch.from_numpy(ct), chunk=32)
    for name, g, t in zip(GRADS, grads, terms):
        assert t.shape == g.shape and t.dtype == torch.float32, name
        assert torch.isfinite(t).all() and (t >= 0).all(), name
        assert (g.abs() <= t * (1 + 1e-5) + 1e-6).all(), name
        assert (t > 2 * g.abs()).any(), name      # some sums cancel
