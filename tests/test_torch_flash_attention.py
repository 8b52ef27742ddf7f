"""Flash-attention parity: the port's `flash_attention` (a CPU tensor takes
the plain version) against the reference.

Where T is a multiple of 128 it is held against the reference's Pallas
`flash_fwd` in interpret mode.  Elsewhere it is held against
`repro.models.layers.attention_ref`, not the Pallas kernel: that kernel
masks on the padded length (flash_attention/kernel.py:89), so its
zero-padded keys enter a non-causal softmax.  The port masks on the true
length.  Tolerances as in tests/test_kernels.py: TOL32 for fp32, TOL for
bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as K, ops as jops
from repro.models.layers import attention_ref

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention as ref_attention

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_bh(q, k, v, dtype, **kw):
    """The port on the Pallas kernel's (BH, S, hd) layout: BH becomes the
    head axis of one batch row."""
    to = lambda a: torch.from_numpy(a.transpose(1, 0, 2)[None]).to(dtype)
    out = ops.flash_attention(to(q), to(k), to(v), **kw)
    return out[0].float().numpy().transpose(1, 0, 2)


@pytest.mark.parametrize("S,hd", [(256, 64), (128, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_matches_pallas_kernel(S, hd, causal, dtype):
    q, k, v = (_normal(i, 2, S, hd) for i in range(3))
    jdt, tdt = DTYPES[dtype]
    got = _port_bh(q, k, v, tdt, causal=causal)
    want = K.flash_fwd(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                       causal=causal, interpret=True)
    tol = TOL32 if dtype == "float32" else TOL
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("window,softcap", [(64, None), (None, 30.0),
                                            (128, 50.0)])
def test_flash_window_softcap_match_pallas_kernel(window, softcap):
    q, k, v = (_normal(i, 1, 256, 64) for i in range(3))
    got = _port_bh(q, k, v, torch.float32, causal=True, window=window,
                   softcap=softcap)
    want = K.flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, window=window, softcap=softcap,
                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL32)


@pytest.mark.parametrize("T", [200, 130])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 64])
def test_flash_masks_true_length(T, causal, hd):
    """GQA H=4, Kh=2 at lengths that are not tile multiples."""
    B, H, Kh = 2, 4, 2
    q, k, v = _normal(0, B, T, H, hd), _normal(1, B, T, Kh, hd), \
        _normal(2, B, T, Kh, hd)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    want = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_flash_bf16_window_softcap_match_attention_ref():
    B, T, H, Kh, hd = 1, 200, 4, 2, 64
    q, k, v = _normal(0, B, T, H, hd), _normal(1, B, T, Kh, hd), \
        _normal(2, B, T, Kh, hd)
    kw = dict(causal=True, window=48, softcap=50.0, q_scale=0.1)
    got = ops.flash_attention(*(torch.from_numpy(a).bfloat16()
                                for a in (q, k, v)), **kw)
    want = attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def test_flash_gqa_head_mapping_matches_reference_wrapper():
    """q head h reads kv head h // (H // Kh), as the reference wrapper's
    jnp.repeat does (at S = 256, where the wrapper needs no padding)."""
    B, S, H, Kh, hd = 2, 256, 8, 2, 64
    q, k, v = _normal(0, B, S, H, hd), _normal(1, B, S, Kh, hd), \
        _normal(2, B, S, Kh, hd)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), True, None, None, None, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


# The tile edges of the card's kernels (128-row query tiles, 128-key tiles):
# the plain version is the oracle the bf16 kernel is held against on the card,
# so it is held here against the reference at the same edges.  The reference
# runs jitted: one compile a shape instead of one per op.
_attention_ref = jax.jit(attention_ref, static_argnames=(
    "causal", "window", "softcap", "q_scale"))


@pytest.mark.parametrize("T", [127, 128, 129, 255, 257, 2064])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tile_edges_match_attention_ref(T, causal):
    B, H, Kh, hd = 1, 2, 1, 16
    q, k, v = _normal(0, B, T, H, hd), _normal(1, B, T, Kh, hd), \
        _normal(2, B, T, Kh, hd)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    want = _attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


@pytest.mark.parametrize("window", [127, 128, 129])
def test_flash_window_edges_softcap_match_attention_ref(window):
    B, T, H, Kh, hd = 1, 300, 2, 1, 32
    q, k, v = _normal(0, B, T, H, hd), _normal(1, B, T, Kh, hd), \
        _normal(2, B, T, Kh, hd)
    kw = dict(causal=True, window=window, softcap=30.0)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    want = _attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_head_dims_and_groups_match_attention_ref(hd, group):
    B, T, H = 1, 129, 4
    Kh = H // group
    q, k, v = _normal(0, B, T, H, hd), _normal(1, B, T, Kh, hd), \
        _normal(2, B, T, Kh, hd)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    want = _attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


# The card's fp32 kernel multiplies on TF32 tensor cores with every operand
# split as x = hi + lo (hi = tf32(x), lo = tf32(x - hi)) and each product
# taken as hi*hi + hi*lo + lo*hi, for S = Q K^T and for O = P V.  This is a
# plain-torch emulation of that arithmetic (the online softmax's tiling is
# fp32 and left out), held against the plain version at the card tests' fp32
# shapes; with one product (hi*hi) it must miss TOL32 at chip_smoke.py's
# main fp32 shape, so TOL32 is what tells the split's products apart.
def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, 10 of the f32 mantissa bits kept (a bit mask on the pattern
    after adding half of the dropped bits' weight)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(eq, a, b, products):
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if products == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + out
    return out


def _attention_tf32(q, k, v, products, causal=True, window=None,
                    softcap=None):
    B, S, H, hd = q.shape
    T, Kh = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Kh, H // Kh, hd) * (1.0 / hd ** 0.5)
    s = _mm_tf32("bskgh,btkh->bkgst", qg, k, products)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pq = torch.arange(S)[:, None]
    pk = torch.arange(T)[None, :]
    keep = torch.ones((S, T), dtype=torch.bool)
    if causal:
        keep &= pk <= pq
    if window is not None:
        keep &= pq - pk < window
    p = torch.softmax(s.masked_fill(~keep, -1e30), dim=-1)
    return _mm_tf32("bkgst,btkh->bskgh", p, v, products).reshape(B, S, H, hd)


def _torch_qkv(B, T, H, Kh, hd):
    return (torch.from_numpy(_normal(0, B, T, H, hd)),
            torch.from_numpy(_normal(1, B, T, Kh, hd)),
            torch.from_numpy(_normal(2, B, T, Kh, hd)))


@pytest.mark.parametrize("S,H,Kh,hd", [(64, 2, 2, 16), (200, 4, 2, 64),
                                       (130, 8, 2, 128), (1, 4, 1, 64),
                                       (24, 4, 4, 32), (100, 4, 2, 32)])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=33, softcap=30.0)])
def test_three_tf32_products_hold_tol32(S, H, Kh, hd, kw):
    q, k, v = _torch_qkv(2, S, H, Kh, hd)
    want = ref_attention(q, k, v, **kw)
    torch.testing.assert_close(_attention_tf32(q, k, v, 3, **kw), want,
                               **TOL32)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_three_tf32_products_hold_tol32_head_dims_and_groups(hd, group):
    q, k, v = _torch_qkv(1, 129, 4, 4 // group, hd)
    torch.testing.assert_close(_attention_tf32(q, k, v, 3),
                               ref_attention(q, k, v), **TOL32)


def test_one_tf32_product_misses_tol32_at_the_main_fp32_shape():
    """chip_smoke.py's fp32 flash shape, B2 T777 H8 Kh8 hd64 non-causal."""
    q, k, v = _torch_qkv(2, 777, 8, 8, 64)
    want = ref_attention(q, k, v, causal=False)
    torch.testing.assert_close(_attention_tf32(q, k, v, 3, causal=False),
                               want, **TOL32)
    assert not torch.allclose(_attention_tf32(q, k, v, 1, causal=False),
                              want, **TOL32)
