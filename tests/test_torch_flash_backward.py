"""Flash-attention gradients: the port against the reference's backward.

The reference's `flash_attention` (Pallas forward in interpret mode) takes
its gradient from `_vjp_bwd`, the lax VJP of `attention_chunked`; each case
runs `jax.vjp` of it once, jitted.  Held against it: the port's CPU
gradient (autograd through `ops.flash_attention` on CPU tensors, the plain
backward a query chunk at a time, `Q_CHUNK` set to 64 so that the chunks
show), and `ref.attention_bwd` fed `ref.attention_lse` and the port's
output, the reverse pass the CUDA backward kernels compute and are held to
on the card; `ref.attention_lse` also against `jax.nn.logsumexp` of the
reference's scores.  Inputs from numpy seeds; TOL32 in fp32, TOL in bf16
(tests/test_kernels.py's).  Cases: the 128-key tile edges (T 127 / 128 /
129), windows 127 / 128 / 129 with a softcap, head dims 16..128 with GQA
groups 1..8, q_scale and non-causal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops

from repro_torch.kernels.flash_attention import ops, ref

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _jax_grads(q, k, v, ct, causal, window, softcap, q_scale):
    _, vjp = jax.vjp(lambda a, b, c: jops.flash_attention(
        a, b, c, causal, window, softcap, q_scale, True), q, k, v)
    return vjp(ct)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _jax_lse(q, k, causal, window, softcap, q_scale):
    """(B, H, S) logsumexp of the reference's masked scores, the scores as
    `attention_ref` forms them."""
    B, S, H, hd = q.shape
    T, Kh = k.shape[1], k.shape[2]
    scale = q_scale if q_scale is not None else 1.0 / np.sqrt(hd)
    qg = jnp.asarray(q).reshape(B, S, Kh, H // Kh, hd) * scale
    s = jnp.einsum("bskgh,btkh->bkgst", qg, jnp.asarray(k),
                   preferred_element_type=jnp.float32)
    if softcap:
        s = softcap * jnp.tanh(s / softcap)
    pq, pk = np.arange(S)[:, None], np.arange(T)[None, :]
    mask = np.ones((S, T), bool)
    if causal:
        mask &= pq >= pk
    if window is not None:
        mask &= pq - pk < window
    s = jnp.where(mask, s, -jnp.inf)
    return jax.nn.logsumexp(s, axis=-1).reshape(B, H, S)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CASES = [  # (B, T, H, Kh, hd, causal, window, softcap, q_scale, dtype)
    (1, 127, 2, 1, 16, True, None, None, None, "float32"),
    (1, 128, 2, 1, 16, False, None, None, 0.2, "float32"),
    (1, 129, 2, 1, 16, True, None, None, None, "float32"),
    (1, 300, 2, 1, 32, True, 127, 30.0, None, "float32"),
    (1, 300, 2, 1, 32, True, 128, 30.0, None, "float32"),
    (1, 300, 2, 1, 32, True, 129, 30.0, 0.1, "float32"),
    (2, 64, 8, 8, 16, True, None, None, None, "float32"),
    (2, 64, 8, 4, 32, True, None, None, None, "float32"),
    (1, 64, 8, 2, 64, False, None, None, None, "float32"),
    (1, 64, 8, 1, 128, True, None, None, 0.0625, "float32"),
    (1, 129, 4, 2, 64, True, None, None, None, "bfloat16"),
    (1, 200, 4, 1, 32, True, 128, 50.0, 0.0625, "bfloat16"),
]


@pytest.mark.parametrize(
    "B,T,H,Kh,hd,causal,window,softcap,q_scale,dtype", CASES,
    ids=[f"B{c[0]}-T{c[1]}-H{c[2]}-Kh{c[3]}-hd{c[4]}-"
         f"{'causal' if c[5] else 'full'}-w{c[6]}-cap{c[7]}-qs{c[8]}-{c[9]}"
         for c in CASES])
def test_flash_gradient_matches_reference_vjp(B, T, H, Kh, hd, causal,
                                              window, softcap, q_scale,
                                              dtype, monkeypatch):
    monkeypatch.setattr(ops, "Q_CHUNK", 64)
    jdt, tdt = DTYPES[dtype]
    q, k, v = _normal(0, B, T, H, hd), _normal(1, B, T, Kh, hd), \
        _normal(2, B, T, Kh, hd)
    ct = _normal(3, B, T, H, hd)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_scale=q_scale)
    want = _jax_grads(*(jnp.asarray(a, jdt) for a in (q, k, v, ct)), causal,
                      window, softcap, q_scale)
    want = [np.asarray(w, np.float32) for w in want]
    tq, tk, tv, tct = (torch.from_numpy(a).to(tdt) for a in (q, k, v, ct))
    tol = TOL32 if dtype == "float32" else TOL

    leaves = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, tct)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt, name
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **tol)

    lse = ref.attention_lse(tq, tk, **kw)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(_jax_lse(tq.float().numpy(),
                                         tk.float().numpy(), causal, window,
                                         softcap, q_scale)), **TOL32)
    plain = ref.attention_bwd(tq, tk, tv, out.detach(), lse, tct, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), plain, want):
        assert g.dtype == tdt, name
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **tol)


@pytest.mark.parametrize("plant", ref.PLANTS)
def test_attention_bwd_plants_miss_tol32(plant):
    """Each planted fault of the plain reverse pass moves some gradient
    outside TOL32 of the unplanted one: the card's checks can reject
    them."""
    B, T, H, Kh, hd = 1, 96, 4, 2, 32
    q, k, v = (torch.from_numpy(_normal(i, B, T, n, hd))
               for i, n in enumerate((H, Kh, Kh)))
    ct = torch.from_numpy(_normal(3, B, T, H, hd))
    o = ref.attention(q, k, v)
    lse = ref.attention_lse(q, k)
    want = ref.attention_bwd(q, k, v, o, lse, ct)
    got = ref.attention_bwd(q, k, v, o, lse, ct, plant=plant)
    assert not all(torch.allclose(g, w, **TOL32) for g, w in zip(got, want))
