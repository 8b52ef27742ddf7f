"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device.  This file imports
only torch and the port, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

chip_smoke.py holds the kernels against their plain versions at the
serving and training paths' full shapes; these are small, quick cases, and
the edges of the kernels' tiles.  Flash attention goes by dtype: bf16 to the
wgmma kernel (`launches`), fp32 to the TF32 mma.sync kernel with three
products a product (`launches_f32`); every flash case checks which one
launched, and the fp32 kernel with one TF32 product must miss TOL32.
The quant pair must equal its plain version bit for bit (wire bytes,
scales, decoded values, the seed the SR launch used), also at the largest
bucket of the full-width path, around the edge of the SR seed pass's grid
and on views whose loads are misaligned.  The gradients of the rmsnorm and
flash `autograd.Function`s are held against autograd through the plain
versions (rmsnorm: kernel forward, plain-torch backward; flash: kernel
forward and backward kernels, `bwd_launches` / `bwd_launches_f32`, also
against the plain reverse pass `ref.attention_bwd`, bit-identical across
calls, with its planted faults missing FLASH_BF16_GRAD_RMS_REL / TOL32).  The SSD's
chunk-parallel forward takes both dtypes (`launches`; fp32 also
`launches_f32`, TF32 mma.sync with three products, whose one-product
variant must miss TOL32); its final state (`ssd_with_state`) is held
against the plain `ssd_chunked`'s, and the state entering the last chunk
in its place must fail; its backward kernels (`bwd_launches`, fp32 also
`bwd_launches_f32`, given the forward's saved states in both dtypes) are
held against the plain reverse-pass backward and against autograd through
the plain chunk loop.  Tolerances: TOL32 (rtol
2e-4, atol 2e-5) for fp32, TOL (2e-2) for bf16, and for bf16 flash and SSD
outputs also an RMS error of FLASH_BF16_RMS_REL / SSD_BF16_RMS_REL of the
output's; the fp32 SSD backward's gradients take TOL32's rtol of the
summed |terms| of each element (`ref.ssd_grad_terms`).
"""

import pytest
import torch

from repro_torch.kernels.adamw import ops as adamw_ops, ref as adamw_ref
from repro_torch.kernels.cross_entropy import ops as xent_ops, \
    ref as xent_ref
from repro_torch.kernels.flash_attention import ops as flash_ops, \
    ref as flash_ref
from repro_torch.kernels.quant import ops as quant_ops, ref as quant_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops, ref as rms_ref
from repro_torch.kernels.ssd import ops as ssd_ops, ref as ssd_ref

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-5)
# bf16 flash outputs, besides TOL: RMS error over the plain output's RMS
# (chip_smoke.py's FLASH_BF16_RMS_REL, where the choice is explained)
FLASH_BF16_RMS_REL = 5e-4
# bf16 SSD outputs, besides TOL (chip_smoke.py's SSD_BF16_RMS_REL)
SSD_BF16_RMS_REL = 2e-4
# bf16 SSD gradients dx, ddt, dB, dC, besides TOL: RMS error over the RMS
# of the plain reverse-pass backward's (chip_smoke.py's
# SSD_BF16_GRAD_RMS_REL, where the choice is explained)
SSD_BF16_GRAD_RMS_REL = 3e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


# Rows of whole 16-byte vectors up to 2048 of them are held in registers:
# the model widths 128, 2048, 4096, 6144 (internvl2-26b) and 7168 (20001,
# 5001 and 1001 rows: more than one pass of the grid-stride loop), and
# other widths, some of which
# leave lanes idle (40, 384 in bf16); 100 (bf16) and 16384 (fp32) take the
# generic kernel
@pytest.mark.parametrize("rows,d", [(8, 128), (9, 384), (33, 4096),
                                    (5, 7168), (7, 100), (20001, 128),
                                    (257, 2048), (5001, 4096), (1001, 7168),
                                    (6, 40), (300, 1536), (17, 5120),
                                    (3, 16384), (9, 6144), (4097, 6144)])
@pytest.mark.parametrize("xdt,wdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("unit_offset", [False, True])
def test_rmsnorm_kernel_matches_plain(dev, rows, d, xdt, wdt, unit_offset):
    x = _randn(dev, rows, d, dtype=xdt) * 2
    w = _randn(dev, d, dtype=wdt, seed=1)
    n = rms_ops.launches
    got = rms_ops.rmsnorm(x, w, 1e-5, unit_offset)
    assert rms_ops.launches == n + 1
    want = rms_ref.rmsnorm(x, w, 1e-5, unit_offset)
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL32 if xdt == torch.float32 else TOL))


def test_rmsnorm_kernel_rejects_what_it_does_not_take(dev):
    x = _randn(dev, 4, 64)
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x.t(), _randn(dev, 4))          # not contiguous
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x, _randn(dev, 64, dtype=torch.bfloat16))


# (130, 32, 4, 128): qwen3-moe-30b-a3b's heads, a GQA group of 8
@pytest.mark.parametrize("S,H,Kh,hd", [(64, 2, 2, 16), (200, 4, 2, 64),
                                       (130, 8, 2, 128), (1, 4, 1, 64),
                                       (24, 4, 4, 32), (100, 4, 2, 32),
                                       (130, 32, 4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=33, softcap=30.0)])
def test_flash_kernel_matches_plain(dev, S, H, Kh, hd, dtype, kw):
    q = _randn(dev, 2, S, H, hd, dtype=dtype)
    k = _randn(dev, 2, S, Kh, hd, dtype=dtype, seed=1)
    v = _randn(dev, 2, S, Kh, hd, dtype=dtype, seed=2)
    _check_flash(q, k, v, kw)


def _check_flash(q, k, v, kw):
    """The kernel against the plain version, and the route by dtype: bf16
    launches the tensor-core kernel, fp32 the CUDA-core one."""
    n, n32 = flash_ops.launches, flash_ops.launches_f32
    got = flash_ops.flash_attention(q, k, v, **kw)
    bf16 = q.dtype == torch.bfloat16
    assert (flash_ops.launches, flash_ops.launches_f32) == \
        ((n + 1, n32) if bf16 else (n, n32 + 1))
    want = flash_ref.attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL if bf16 else TOL32))
    if bf16:
        err = (got.float() - want.float()).pow(2).mean().sqrt()
        assert err <= FLASH_BF16_RMS_REL * want.float().pow(2).mean().sqrt()


@pytest.mark.parametrize("T", [127, 128, 129, 255, 257, 2064])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_kernel_tile_edges(dev, T, causal):
    """Query and key tiles are 128 rows: ragged last tiles, the causal
    diagonal tile and keys past T."""
    q = _randn(dev, 1, T, 4, 128, dtype=torch.bfloat16)
    k = _randn(dev, 1, T, 2, 128, dtype=torch.bfloat16, seed=1)
    v = _randn(dev, 1, T, 2, 128, dtype=torch.bfloat16, seed=2)
    _check_flash(q, k, v, dict(causal=causal))


@pytest.mark.parametrize("window", [127, 128, 129])
def test_flash_bf16_kernel_window_edges_softcap(dev, window):
    q = _randn(dev, 2, 600, 4, 64, dtype=torch.bfloat16)
    k = _randn(dev, 2, 600, 2, 64, dtype=torch.bfloat16, seed=1)
    v = _randn(dev, 2, 600, 2, 64, dtype=torch.bfloat16, seed=2)
    _check_flash(q, k, v, dict(causal=True, window=window, softcap=30.0))


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_bf16_kernel_head_dims_and_groups(dev, hd, group):
    q = _randn(dev, 2, 300, 8, hd, dtype=torch.bfloat16)
    k = _randn(dev, 2, 300, 8 // group, hd, dtype=torch.bfloat16, seed=1)
    v = _randn(dev, 2, 300, 8 // group, hd, dtype=torch.bfloat16, seed=2)
    _check_flash(q, k, v, dict(causal=True))


@pytest.mark.parametrize("S,heads,hd", [(77, (8, 2, 2), 64),
                                         (515, (32, 8, 8), 128)])
def test_flash_kernel_reads_strided_heads(dev, S, heads, hd):
    """q, k and v as head slices of one packed projection."""
    qkv = _randn(dev, 2, S, sum(heads), hd, dtype=torch.bfloat16)
    q, k, v = qkv.split(list(heads), dim=2)
    _check_flash(q, k, v, dict(causal=True))


def test_flash_bf16_kernel_rejects_misaligned_strides(dev):
    """TMA reads 16-byte aligned bases and strides of 8-element multiples."""
    wide = _randn(dev, 1, 64, 2, 70, dtype=torch.bfloat16)
    q = wide[..., :64]                       # head stride 70 elements
    k = _randn(dev, 1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        flash_ops.flash_attention(q, k, k)
    flat = _randn(dev, 1 + 64 * 2 * 64, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 64, 2, 64)    # base 2 bytes off
    with pytest.raises(ValueError, match="TMA"):
        flash_ops.flash_attention(k, shifted, k)


@pytest.mark.parametrize("T", [63, 64, 65, 129, 2064])
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_kernel_tile_edges(dev, T, hd, causal):
    """fp32 query tiles are 64 rows, key tiles 32 keys."""
    q = _randn(dev, 1, T, 4, hd)
    k = _randn(dev, 1, T, 2, hd, seed=1)
    v = _randn(dev, 1, T, 2, hd, seed=2)
    _check_flash(q, k, v, dict(causal=causal))


@pytest.mark.parametrize("window", [63, 64, 65])
def test_flash_f32_kernel_window_edges_softcap(dev, window):
    q = _randn(dev, 2, 300, 4, 64)
    k = _randn(dev, 2, 300, 2, 64, seed=1)
    v = _randn(dev, 2, 300, 2, 64, seed=2)
    _check_flash(q, k, v, dict(causal=True, window=window, softcap=30.0))


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_f32_kernel_head_dims_and_groups(dev, hd, group):
    q = _randn(dev, 2, 300, 8, hd)
    k = _randn(dev, 2, 300, 8 // group, hd, seed=1)
    v = _randn(dev, 2, 300, 8 // group, hd, seed=2)
    _check_flash(q, k, v, dict(causal=True))


@pytest.mark.parametrize("hd", [32, 128])
def test_flash_f32_kernel_reads_strided_and_unaligned_heads(dev, hd):
    """q/k/v as head slices of one packed projection (16-byte copies), and
    k/v one element off 16-byte alignment (element copies)."""
    q, k, v = _randn(dev, 2, 77, 12, hd).split([8, 2, 2], dim=2)
    _check_flash(q, k, v, dict(causal=True))
    flat = _randn(dev, 1 + 2 * 100 * 2 * hd, seed=1)
    kv = flat[1:].view(2, 100, 2, hd)
    _check_flash(_randn(dev, 2, 100, 4, hd), kv, kv, dict(causal=False))


def test_flash_f32_kernel_with_one_tf32_product_misses_tol32(dev):
    """The planted fault: hi*hi alone, at chip_smoke.py's fp32 shape."""
    q = _randn(dev, 2, 777, 8, 64)
    k = _randn(dev, 2, 777, 8, 64, seed=1)
    v = _randn(dev, 2, 777, 8, 64, seed=2)
    want = flash_ref.attention(q, k, v, causal=False)
    got = flash_ops.flash_attention_cuda(q, k, v, False, None, None, None)
    torch.testing.assert_close(got, want, **TOL32)
    one = flash_ops.flash_attention_cuda(q, k, v, False, None, None, None,
                                         tf32_products=1)
    assert not torch.allclose(one, want, **TOL32)


def test_flash_kernel_rejects_unsupported_head_dim(dev):
    q = _randn(dev, 1, 8, 2, 48)
    with pytest.raises(ValueError, match="hd"):
        flash_ops.flash_attention(q, q, q)


def _grads(fn, inputs, ct):
    inputs = [a.detach().requires_grad_() for a in inputs]
    out = fn(*inputs)
    return (out, *torch.autograd.grad(out, inputs, ct))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_gradient_matches_plain_autograd(dev, dtype):
    x = _randn(dev, 2, 33, 256, dtype=dtype) * 2
    w = _randn(dev, 256, dtype=dtype, seed=1)
    ct = _randn(dev, 2, 33, 256, dtype=dtype, seed=2)
    n = rms_ops.launches
    got = _grads(lambda a, b: rms_ops.rmsnorm(a, b, 1e-5), (x, w), ct)
    assert rms_ops.launches == n + 1
    want = _grads(lambda a, b: rms_ref.rmsnorm(a, b, 1e-5), (x, w), ct)
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a.float(), b.float(), **(TOL32 if dtype == torch.float32 else TOL))


@pytest.mark.parametrize("S,T_chunk", [(200, 64), (130, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradient_matches_plain_autograd(dev, S, T_chunk, dtype,
                                               monkeypatch):
    monkeypatch.setattr(flash_ops, "Q_CHUNK", T_chunk)
    q = _randn(dev, 2, S, 4, 64, dtype=dtype)
    k = _randn(dev, 2, S, 2, 64, dtype=dtype, seed=1)
    v = _randn(dev, 2, S, 2, 64, dtype=dtype, seed=2)
    ct = _randn(dev, 2, S, 4, 64, dtype=dtype, seed=3)
    n = flash_ops.launches + flash_ops.launches_f32
    nb = flash_ops.bwd_launches + flash_ops.bwd_launches_f32
    got = _grads(lambda *a: flash_ops.flash_attention(*a), (q, k, v), ct)
    assert flash_ops.launches + flash_ops.launches_f32 == n + 1
    assert flash_ops.bwd_launches + flash_ops.bwd_launches_f32 == nb + 1
    want = _grads(lambda *a: flash_ref.attention(*a), (q, k, v), ct)
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a.float(), b.float(), **(TOL32 if dtype == torch.float32 else TOL))


# The backward kernels (bf16: flash_attention_bwd_sm90.cu, one pass over
# work items of 128 keys of a (b, kv head) that walk 64-row Q / dO tiles for
# the group's query heads, dQ summed over key blocks in a fixed order;
# fp32: flash_attention.cu, 64-row / 64-key blocks over 32-row / 32-key
# tiles) on the forward's o and lse, against the plain reverse pass and
# autograd through the plain version: tile edges, windows with a softcap,
# head dims and groups, q_scale, non-causal, qwen3's S = T = 2048 at H16 /
# Kh8.
FLASH_BWD_CASES = [  # (B, T, H, Kh, hd, kwargs)
    (1, 127, 4, 2, 128, dict(causal=True)),
    (1, 128, 4, 2, 128, dict(causal=True)),
    (1, 129, 4, 2, 128, dict(causal=True)),
    (2, 129, 4, 2, 64, dict(causal=False)),
    (2, 63, 4, 1, 32, dict(causal=False, q_scale=0.3)),
    (2, 600, 4, 2, 64, dict(causal=True, window=127, softcap=30.0)),
    (2, 600, 4, 2, 64, dict(causal=True, window=128, softcap=30.0)),
    (2, 600, 4, 2, 64, dict(causal=True, window=129, softcap=30.0,
                            q_scale=0.0625)),
    (2, 300, 8, 8, 16, dict(causal=True)),
    (2, 300, 8, 4, 32, dict(causal=True)),
    (2, 300, 8, 2, 64, dict(causal=True)),
    (2, 300, 8, 1, 128, dict(causal=True)),
    (1, 2048, 16, 8, 128, dict(causal=True)),
]
# bf16 gradients against the plain reverse pass: chip_smoke.py's
# FLASH_BF16_GRAD_RMS_REL, where the value is explained
FLASH_BF16_GRAD_RMS_REL = 1e-3


def _flash_bwd_inputs(dev, B, T, H, Kh, hd, dtype):
    return (_randn(dev, B, T, H, hd, dtype=dtype),
            _randn(dev, B, T, Kh, hd, dtype=dtype, seed=1),
            _randn(dev, B, T, Kh, hd, dtype=dtype, seed=2),
            _randn(dev, B, T, H, hd, dtype=dtype, seed=3))


def _fwd_lse(q, k, v, kw):
    return flash_ops.flash_attention_cuda(
        q, k, v, kw["causal"], kw.get("window"), kw.get("softcap"),
        kw.get("q_scale"), with_lse=True)


def _rms_rel(got, want):
    e, w = got.float() - want.float(), want.float()
    return (e.pow(2).mean().sqrt() / w.pow(2).mean().sqrt()).item()


@pytest.mark.parametrize("B,T,H,Kh,hd,kw", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain(dev, B, T, H, Kh, hd, kw, dtype):
    q, k, v, ct = _flash_bwd_inputs(dev, B, T, H, Kh, hd, dtype)
    o, lse = _fwd_lse(q, k, v, kw)
    torch.testing.assert_close(lse, flash_ref.attention_lse(q, k, **kw),
                               **TOL32)
    n = (flash_ops.bwd_launches, flash_ops.bwd_launches_f32)
    got = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct, **kw)
    bf16 = dtype == torch.bfloat16
    assert (flash_ops.bwd_launches - n[0],
            flash_ops.bwd_launches_f32 - n[1]) == ((1, 0) if bf16 else (0, 1))
    assert [g.dtype for g in got] == [dtype] * 3
    want = flash_ref.attention_bwd(q, k, v, o, lse, ct, **kw)
    auto = _grads(lambda *a: flash_ref.attention(*a, **kw), (q, k, v), ct)
    for a, b, c in zip(got, want, auto[1:]):
        tol = TOL if bf16 else TOL32
        torch.testing.assert_close(a.float(), b.float(), **tol)
        torch.testing.assert_close(a.float(), c.float(), **tol)
        if bf16:
            assert _rms_rel(a, b) <= FLASH_BF16_GRAD_RMS_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_are_deterministic(dev, dtype):
    """Every output element is written by one block in a fixed order: two
    calls agree bit for bit (restarts stay bit-exact)."""
    q, k, v, ct = _flash_bwd_inputs(dev, 2, 515, 8, 2, 128, dtype)
    o, lse = _fwd_lse(q, k, v, dict(causal=True))
    a = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct)
    b = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# Many key blocks adding into each dQ tile in their fixed order: a GQA
# group of 6 at T 2048 (16 key blocks), a window with a softcap at T 4096,
# and a window edge at hd 64
FLASH_BWD_ORDERED = [
    (2, 2048, 12, 2, 128, dict(causal=True)),
    (1, 4096, 4, 2, 128, dict(causal=True, window=1000, softcap=50.0,
                              q_scale=1 / 16)),
    (2, 600, 4, 2, 64, dict(causal=True, window=129, softcap=30.0)),
]


@pytest.mark.parametrize("B,T,H,Kh,hd,kw", FLASH_BWD_ORDERED)
def test_flash_bwd_bf16_is_bit_identical_and_keeps_no_state(dev, B, T, H,
                                                            Kh, hd, kw):
    """Two bf16 backward calls agree bit for bit, with a call on other
    inputs between them (its scratch, likely the same memory, carries
    nothing over), and each dQ tile took as many key blocks' partials as
    `ops.bwd_schedule` lists for it."""
    q, k, v, ct = _flash_bwd_inputs(dev, B, T, H, Kh, hd, torch.bfloat16)
    o, lse = _fwd_lse(q, k, v, kw)
    first = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct,
                                               with_counts=True, **kw)
    q2, k2, v2, ct2 = (_randn(dev, *t.shape, dtype=torch.bfloat16,
                              seed=10 + i)
                       for i, t in enumerate((q, k, v, ct)))
    o2, lse2 = _fwd_lse(q2, k2, v2, kw)
    flash_ops.flash_attention_bwd_cuda(q2, k2, v2, o2, lse2, ct2, **kw)
    again = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first[:3], again))
    want = torch.tensor([len(x) for x in flash_ops.bwd_schedule(
        T, T, kw["causal"], kw.get("window"))], dtype=torch.int32,
        device=dev)
    assert torch.equal(first[3], want.expand(B, H, -1))


def test_flash_bwd_bf16_plants_miss_their_limits(dev):
    """Each planted fault of the plain reverse pass fails TOL or
    FLASH_BF16_GRAD_RMS_REL against the unplanted one, which the kernels
    pass, at qwen3-1.7b's layer shape."""
    q, k, v, ct = _flash_bwd_inputs(dev, 1, 2048, 16, 8, 128, torch.bfloat16)
    o, lse = _fwd_lse(q, k, v, dict(causal=True))
    want = flash_ref.attention_bwd(q, k, v, o, lse, ct)
    for plant in flash_ref.PLANTS:
        got = flash_ref.attention_bwd(q, k, v, o, lse, ct, plant=plant)
        assert any(_rms_rel(a, b) > FLASH_BF16_GRAD_RMS_REL
                   or not torch.allclose(a.float(), b.float(), **TOL)
                   for a, b in zip(got, want)), plant


def test_flash_bwd_f32_with_one_tf32_product_misses_tol32(dev):
    q, k, v, ct = _flash_bwd_inputs(dev, 2, 777, 8, 8, 64, torch.float32)
    kw = dict(causal=False)
    o, lse = _fwd_lse(q, k, v, kw)
    want = _grads(lambda *a: flash_ref.attention(*a, **kw), (q, k, v), ct)
    got = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct, **kw)
    for a, b in zip(got, want[1:]):
        torch.testing.assert_close(a, b, **TOL32)
    one = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct,
                                             tf32_products=1, **kw)
    assert not all(torch.allclose(a, b, **TOL32)
                   for a, b in zip(one, want[1:]))


def test_flash_bwd_reads_strided_heads_and_cotangent(dev):
    """q, k, v as head slices of one packed projection; a cotangent that
    TMA cannot read (a transposed view) is made contiguous first."""
    qkv = _randn(dev, 2, 200, 12, 64, dtype=torch.bfloat16)
    q, k, v = qkv.split([8, 2, 2], dim=2)
    ct = _randn(dev, 2, 8, 200, 64, dtype=torch.bfloat16, seed=3)
    ct = ct.transpose(1, 2)
    o, lse = _fwd_lse(q, k, v, dict(causal=True))
    got = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct)
    want = flash_ref.attention_bwd(q, k, v, o, lse, ct)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **TOL)


@pytest.mark.parametrize("form", ["sum", "batch_expanded", "hd_strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_takes_expanded_and_strided_cotangents(dev, dtype, form):
    """Autograd's cotangent of `.sum()` is expanded (every stride 0), one
    broadcast over the batch has a batch stride of 0, and a slice of a wider
    tensor has no unit hd stride: the kernels see each as a contiguous
    copy."""
    q, k, v, ct = _flash_bwd_inputs(dev, 2, 200, 8, 2, 64, dtype)
    if form == "sum":
        ct = torch.ones((), dtype=dtype, device=dev).expand(q.shape)
    elif form == "batch_expanded":
        ct = ct[:1].expand(q.shape)
    else:
        ct = _randn(dev, 2, 200, 8, 128, dtype=dtype, seed=3)[..., ::2]
    o, lse = _fwd_lse(q, k, v, dict(causal=True))
    want = flash_ref.attention_bwd(q, k, v, o, lse, ct.contiguous())
    tol = TOL if dtype == torch.bfloat16 else TOL32
    got = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct)
    if form == "sum":
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        n = flash_ops.bwd_launches + flash_ops.bwd_launches_f32
        flash_ops.flash_attention(*leaves).sum().backward()
        assert flash_ops.bwd_launches + flash_ops.bwd_launches_f32 == n + 1
        got = [t.grad for t in leaves]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **tol)


# seamless-m4t-large-v2's attentions: hd 64, 16 heads on 16 kv heads; the
# encoder's self-attention and the cross-attention are non-causal, the
# decoder's self-attention causal, at S = T = 1024 (the training shape,
# half its batch), in both dtypes (fp32: the card-vs-CPU checks); the
# serve prefill's cross-attention reads the padded prompt's 2064 queries
# against the 1032 frames' keys; (300, 150) and (150, 300) put ragged
# tiles on either side of S != T
SEAMLESS_FLASH = [(1024, 1024, False), (1024, 1024, True),
                  (2064, 1032, False), (300, 150, False), (150, 300, False)]


@pytest.mark.parametrize("S,T,causal", SEAMLESS_FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_seamless_shapes(dev, S, T, causal, dtype):
    q = _randn(dev, 2, S, 16, 64, dtype=dtype)
    k = _randn(dev, 2, T, 16, 64, dtype=dtype, seed=1)
    v = _randn(dev, 2, T, 16, 64, dtype=dtype, seed=2)
    _check_flash(q, k, v, dict(causal=causal))


@pytest.mark.parametrize("S,T,causal", [c for c in SEAMLESS_FLASH
                                        if c[0] <= 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_at_seamless_shapes(dev, S, T, causal, dtype):
    """The backward kernels against the plain reverse pass and autograd
    through the plain version, as `test_flash_bwd_kernels_match_plain`,
    with q over S rows and k, v over T."""
    kw = dict(causal=causal)
    q = _randn(dev, 2, S, 16, 64, dtype=dtype)
    k = _randn(dev, 2, T, 16, 64, dtype=dtype, seed=1)
    v = _randn(dev, 2, T, 16, 64, dtype=dtype, seed=2)
    ct = _randn(dev, 2, S, 16, 64, dtype=dtype, seed=3)
    o, lse = _fwd_lse(q, k, v, kw)
    torch.testing.assert_close(lse, flash_ref.attention_lse(q, k, **kw),
                               **TOL32)
    bf16 = dtype == torch.bfloat16
    n = (flash_ops.bwd_launches, flash_ops.bwd_launches_f32)
    got = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct, **kw)
    assert (flash_ops.bwd_launches - n[0],
            flash_ops.bwd_launches_f32 - n[1]) == ((1, 0) if bf16 else (0, 1))
    want = flash_ref.attention_bwd(q, k, v, o, lse, ct, **kw)
    auto = _grads(lambda *a: flash_ref.attention(*a, **kw), (q, k, v), ct)
    tol = TOL if bf16 else TOL32
    for a, b, c in zip(got, want, auto[1:]):
        torch.testing.assert_close(a.float(), b.float(), **tol)
        torch.testing.assert_close(a.float(), c.float(), **tol)
        if bf16:
            assert _rms_rel(a, b) <= FLASH_BF16_GRAD_RMS_REL


# internvl2-26b's attention: 48 query heads on 8 kv heads of 128, a GQA
# group of 6 (the kv head of query head h is h // 6, and the dK / dV
# kernel walks 6 query heads' Q tiles a kv head).  The `group` cases above
# take 8 // group kv heads, so 6 is not among them: a short case, 12 heads
# on 2, beside the training shape B2 T2048 and the serve prefill's length,
# 1025 image positions + 2064 text tokens
VLM_GROUP6 = [(2, 300, 12, 2), (1, 3089, 12, 2), (2, 2048, 48, 8)]


@pytest.mark.parametrize("B,T,H,Kh", VLM_GROUP6)
def test_flash_bf16_kernel_at_a_gqa_group_of_6(dev, B, T, H, Kh):
    q = _randn(dev, B, T, H, 128, dtype=torch.bfloat16)
    k = _randn(dev, B, T, Kh, 128, dtype=torch.bfloat16, seed=1)
    v = _randn(dev, B, T, Kh, 128, dtype=torch.bfloat16, seed=2)
    _check_flash(q, k, v, dict(causal=True))


@pytest.mark.parametrize("B,T,H,Kh", [c for c in VLM_GROUP6 if c[1] <= 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_at_a_gqa_group_of_6(dev, B, T, H, Kh, dtype):
    """The backward kernels at a group of 6 against the plain reverse pass
    and autograd through the plain version, as
    `test_flash_bwd_kernels_match_plain`."""
    kw = dict(causal=True)
    q, k, v, ct = _flash_bwd_inputs(dev, B, T, H, Kh, 128, dtype)
    o, lse = _fwd_lse(q, k, v, kw)
    torch.testing.assert_close(lse, flash_ref.attention_lse(q, k, **kw),
                               **TOL32)
    bf16 = dtype == torch.bfloat16
    n = (flash_ops.bwd_launches, flash_ops.bwd_launches_f32)
    got = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct, **kw)
    assert (flash_ops.bwd_launches - n[0],
            flash_ops.bwd_launches_f32 - n[1]) == ((1, 0) if bf16 else (0, 1))
    want = flash_ref.attention_bwd(q, k, v, o, lse, ct, **kw)
    auto = _grads(lambda *a: flash_ref.attention(*a, **kw), (q, k, v), ct)
    tol = TOL if bf16 else TOL32
    for a, b, c in zip(got, want, auto[1:]):
        torch.testing.assert_close(a.float(), b.float(), **tol)
        torch.testing.assert_close(a.float(), c.float(), **tol)
        if bf16:
            assert _rms_rel(a, b) <= FLASH_BF16_GRAD_RMS_REL


def test_flash_bwd_rejects_what_the_forward_rejects(dev):
    q, k, v, ct = _flash_bwd_inputs(dev, 1, 64, 2, 2, 64, torch.bfloat16)
    o, lse = _fwd_lse(q, k, v, dict(causal=True))
    wide = _randn(dev, 1, 64, 2, 70, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="TMA"):
        flash_ops.flash_attention_bwd_cuda(wide, k, v, o, lse, ct)
    with pytest.raises(TypeError):
        flash_ops.flash_attention_bwd_cuda(q, k.float(), v, o, lse, ct)
    with pytest.raises(ValueError, match="hd"):
        x = _randn(dev, 1, 8, 2, 48, dtype=torch.bfloat16)
        flash_ops.flash_attention_bwd_cuda(x, x, x, x, lse[..., :8], x)
    with pytest.raises(ValueError, match="lse"):
        flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse.bfloat16(), ct)
    strided_o = torch.zeros(*o.shape[:3], 2 * o.shape[3], dtype=o.dtype,
                            device=o.device)[..., ::2]
    strided_o.copy_(o)                       # unit stride on hd lost
    with pytest.raises(ValueError, match="o's rows"):
        flash_ops.flash_attention_bwd_cuda(q, k, v, strided_o, lse, ct)
    with pytest.raises(ValueError, match="window"):
        flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct, window=0)


def _per_g(dx, g):
    return dx.float() / g.float().abs()[:, None]


@pytest.mark.parametrize("R,V", [(8, 2048), (9, 5000), (16, 4096), (3, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tdtype", [torch.int32, torch.int64])
def test_xent_kernels_match_plain(dev, R, V, dtype, tdtype):
    x = _randn(dev, R, V, dtype=dtype) * 3
    t = torch.randint(0, V, (R,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(4))
    t = t.to(tdtype)
    t[0] = V + 5                       # out of range: no target logit
    g = _randn(dev, R, seed=5)
    nf, nb = xent_ops.fwd_launches, xent_ops.bwd_launches
    loss, lse = xent_ops.xent_fwd_cuda(x, t)
    dx = xent_ops.xent_bwd_cuda(x, t, lse, g)
    assert (xent_ops.fwd_launches, xent_ops.bwd_launches) == (nf + 1, nb + 1)
    want_loss, want_lse = xent_ref.xent(x, t)
    torch.testing.assert_close(loss, want_loss, **TOL32)
    torch.testing.assert_close(lse, want_lse, **TOL32)
    # each row over |g|: softmax - onehot, so the softmax terms meet the
    # tolerance at their own size, not scaled down by g
    want = _per_g(xent_ref.dlogits(x, t, want_lse, g), g)
    tol = TOL32 if dtype == torch.float32 else TOL
    torch.testing.assert_close(_per_g(dx, g), want, **tol)
    assert dx.dtype == dtype
    onehot_only = torch.zeros_like(x).scatter_(
        1, t.long().clamp(0, V - 1)[:, None], -g[:, None].to(dtype))
    assert not torch.allclose(_per_g(onehot_only, g), want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_kernels_at_the_vlm_vocab_with_masked_rows(dev, dtype):
    """internvl2-26b's vocabulary, 92560 (not a multiple of 128: a ragged
    last tile), on two sequences of 40 rows whose first 17 are image
    positions: `valid` 0 there, so their cotangent is 0 and their dlogits
    exactly 0, and the masked mean of the losses the plain version's."""
    R, V, n_img = 80, 92_560, 17
    x = _randn(dev, R, V, dtype=dtype) * 3
    t = torch.randint(0, V, (R,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(4))
    t[1] = V - 1                       # a target in the last tile
    valid = (torch.arange(R, device=dev) % 40 >= n_img).float()
    g = _randn(dev, R, seed=5) * valid
    loss, lse = xent_ops.xent_fwd_cuda(x, t)
    dx = xent_ops.xent_bwd_cuda(x, t, lse, g)
    want_loss, want_lse = xent_ref.xent(x, t)
    torch.testing.assert_close(loss, want_loss, **TOL32)
    torch.testing.assert_close(lse, want_lse, **TOL32)
    mean = lambda a: (a * valid).sum() / valid.sum()  # noqa: E731
    torch.testing.assert_close(mean(loss), mean(want_loss), **TOL32)
    assert int(dx[valid == 0].count_nonzero()) == 0
    live = valid > 0
    want = _per_g(xent_ref.dlogits(x, t, want_lse, g)[live], g[live])
    tol = TOL32 if dtype == torch.float32 else TOL
    torch.testing.assert_close(_per_g(dx[live], g[live]), want, **tol)


def test_xent_autograd_function_matches_plain(dev):
    x = _randn(dev, 9, 5000) * 3
    t = torch.arange(9, device=dev) * 500
    ct = _randn(dev, 9, seed=1)
    got = _grads(lambda a: xent_ops.xent(a, t), (x,), ct)
    want = _grads(lambda a: xent_ref.xent(a, t)[0], (x,), ct)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL32)


def test_xent_kernels_reject_what_they_do_not_take(dev):
    x = _randn(dev, 4, 64)
    t = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        xent_ops.xent_fwd_cuda(x.t(), t)               # not contiguous
    with pytest.raises(TypeError):
        xent_ops.xent_fwd_cuda(x.half(), t)
    with pytest.raises(TypeError):
        xent_ops.xent_fwd_cuda(x, t.float())


@pytest.mark.parametrize("n", [5000, 4096, 1, 1_000_003])
def test_adamw_kernel_matches_plain(dev, n):
    p, g, m = (_randn(dev, n, seed=s) for s in range(3))
    v = _randn(dev, n, seed=3).abs()
    lr = torch.tensor(3e-4, device=dev)
    t = torch.tensor(7, dtype=torch.int32, device=dev)
    scale = torch.tensor(0.5, device=dev)
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    want = adamw_ref.adamw_update(p, g, m, v, lr=lr, t=t, scale=scale,
                                  **hyper)
    p0 = p.clone()
    k = adamw_ops.launches
    adamw_ops.adamw_update(p, g, m, v, lr=lr, t=t, scale=scale, **hyper)
    assert adamw_ops.launches == k + 1
    torch.testing.assert_close(p - p0, want[0] - p0, **TOL32)
    for a, b in zip((p, m, v), want):
        torch.testing.assert_close(a, b, **TOL32)


@pytest.mark.parametrize("n", [5000, 1_000_003])
def test_adamw_kernel_applies_weight_decay(dev, n):
    """lr 1e-2, wd 1: dropping the decay moves the update by 1e-2*|p|,
    far outside TOL32, so the update p_new - p is held to the plain one."""
    p, g, m = (_randn(dev, n, seed=s) for s in range(3))
    v = _randn(dev, n, seed=3).abs()
    kw = dict(lr=torch.tensor(1e-2, device=dev),
              t=torch.tensor(3, dtype=torch.int32, device=dev),
              scale=torch.tensor(1.0, device=dev), b1=0.9, b2=0.95, eps=1e-8)
    want = adamw_ref.adamw_update(p, g, m, v, wd=1.0, **kw)[0] - p
    no_decay = adamw_ref.adamw_update(p, g, m, v, wd=0.0, **kw)[0] - p
    assert not torch.allclose(no_decay, want, **TOL32)
    p0 = p.clone()
    adamw_ops.adamw_update(p, g, m, v, wd=1.0, **kw)
    torch.testing.assert_close(p - p0, want, **TOL32)


def test_adamw_kernel_rejects_what_it_does_not_take(dev):
    p = _randn(dev, 64)
    lr, scale = torch.tensor(1e-3, device=dev), torch.tensor(1.0, device=dev)
    t = torch.tensor(1, dtype=torch.int32, device=dev)
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    with pytest.raises(ValueError):
        adamw_ops.adamw_update(p, p.bfloat16(), p.clone(), p.clone(), lr=lr,
                               t=t, scale=scale, **hyper)
    with pytest.raises(ValueError):
        adamw_ops.adamw_update(p, p.clone(), p.clone(), p.clone(), lr=lr,
                               t=t.float(), scale=scale, **hyper)


def codec_input(n, dtype, dev, seed=0):
    """A buffer for the wire codec: random values, an all-zero first chunk
    and, where n allows, a chunk whose absmax is 127 holding int8 ties
    (k + 0.5 at scale 1.0) and one whose absmax is 448 holding e4m3 ties
    (1.0625, 17, ...); both hold values at exactly +-QMAX * scale."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * 3
    x[:quant_ref.QCHUNK] = 0
    c = quant_ref.QCHUNK
    if n >= 3 * c:
        x[c:c + 20] = torch.arange(-10, 10) + 0.5
        x[c + 20], x[c + 21] = 127.0, -127.0
        x[2 * c:2 * c + 6] = torch.tensor([448.0, -448.0, 1.0625, -17.0,
                                           0.5 + 2 ** -5, 208.0])
    return x.to(dtype).to(dev)


def _bits(a):
    return a.float().view(torch.int32)


def _check_codec(x, codec, stochastic):
    """Wire bytes, scales, decoded values and (SR) the seed the launch used,
    bit for bit the plain version's; the round trip, also in place."""
    n, dtype = x.numel(), x.dtype
    seed = torch.empty(1, dtype=torch.int32, device=x.device) \
        if stochastic else None
    nq, nd = quant_ops.quant_launches, quant_ops.dequant_launches
    q, s = quant_ops.quantize_cuda(x, codec, stochastic, seed_out=seed)
    assert quant_ops.quant_launches == nq + 1
    wq, ws = quant_ref.quantize(x, codec, stochastic)
    assert q.dtype == wq.dtype and q.shape == wq.shape
    assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8))
    assert torch.equal(_bits(s), _bits(ws))
    if stochastic:
        want_seed = int(quant_ref.buffer_seed(quant_ref.chunk(x)[0]))
        assert int(seed.item()) & quant_ref.M32 == want_seed
    out = quant_ops.dequantize_cuda(q, s, n, x.shape, dtype)
    assert quant_ops.dequant_launches == nd + 1
    want = quant_ref.dequantize(wq, ws, n, x.shape, dtype)
    assert out.dtype == dtype and torch.equal(_bits(out), _bits(want))
    rt = quant_ops.roundtrip(x, codec, stochastic)
    assert torch.equal(_bits(rt), _bits(want))
    # in place, as the reduce-scatter round-trips its gradient buffer
    y = x.clone()
    rt = quant_ops.roundtrip(y, codec, stochastic, out=y)
    assert rt.data_ptr() == y.data_ptr()
    assert torch.equal(_bits(y), _bits(want))


CODEC_CASES = pytest.mark.parametrize("dtype,codec,stochastic", [
    (dt, c, sr) for dt in (torch.float32, torch.bfloat16)
    for c in ("fp8", "int8") for sr in (False, True)])


@pytest.mark.parametrize("n", [129, 1024, 5000, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("codec", ["fp8", "int8"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_quant_kernels_match_plain_bit_for_bit(dev, n, dtype, codec,
                                               stochastic):
    _check_codec(codec_input(n, dtype, dev, seed=n), codec, stochastic)


@CODEC_CASES
def test_quant_kernels_at_the_largest_bucket(dev, dtype, codec, stochastic):
    """37,750,784 elements: the largest bucket of qwen3-1.7b's full-width
    prefetch path (chip_smoke.py's quant phase)."""
    _check_codec(codec_input(37_750_784, dtype, dev, seed=3), codec,
                 stochastic)


@pytest.mark.parametrize("extra", [-128, -1, 0, 1, 128])
@CODEC_CASES
def test_quant_kernels_around_the_seed_pass_edge(dev, extra, dtype, codec,
                                                 stochastic):
    """n at one pass of the SR seed kernel's grid, one chunk or one element
    either side: its loop ends on the last step, or a second pass takes a
    chunk or one element of one."""
    n = quant_ops.sr_seed_pass(dtype, dev) + extra
    _check_codec(codec_input(n, dtype, dev, seed=4), codec, stochastic)


@CODEC_CASES
def test_quant_kernels_on_a_misaligned_view(dev, dtype, codec, stochastic):
    """A view one element past a 16-byte boundary: element loads."""
    x = codec_input(5001, dtype, dev, seed=5)[1:]
    assert x.data_ptr() % 16
    _check_codec(x, codec, stochastic)


def test_quant_kernels_reject_what_they_do_not_take(dev):
    x = _randn(dev, 256)
    with pytest.raises(ValueError):
        quant_ops.quantize_cuda(x.half(), "fp8", False)
    with pytest.raises(ValueError):
        quant_ops.quantize_cuda(x.reshape(2, 128).t(), "fp8", False)
    with pytest.raises(ValueError):
        quant_ops.quantize_cuda(x, "fp4", False)
    q, s = quant_ops.quantize_cuda(x, "int8", False)
    with pytest.raises(ValueError):
        quant_ops.dequantize_cuda(q, s, 300, (300,), torch.float32)
    with pytest.raises(ValueError):
        quant_ops.dequantize_cuda(q, s.double(), 256, (256,), torch.float32)
    with pytest.raises(ValueError):
        quant_ops.dequantize_cuda(q, s, 256, (256,), torch.float32,
                                  out=x.bfloat16())


# ---------------------------------------------------------------------------
# SSD chunk scan
# ---------------------------------------------------------------------------
SSD_SHAPES = [  # B, T, H, P, G, N, chunk: test_ssd_sweep, smoke, full-ish
    (2, 96, 4, 16, 2, 8, 32), (2, 128, 2, 32, 1, 16, 64),
    (2, 64, 4, 16, 4, 8, 64), (2, 24, 8, 16, 1, 8, 16),
    (1, 300, 4, 64, 1, 64, 128), (1, 12, 2, 32, 1, 16, 16),
    # N whose rows are no whole 16-byte vectors (element loads) or odd
    (2, 40, 4, 32, 2, 12, 16), (1, 40, 2, 16, 1, 5, 16),
]


def _ssd_inputs(dev, B, T, H, P, G, N, dtype, seed=0):
    x = _randn(dev, B, T, H, P, seed=seed).to(dtype)
    dt = torch.nn.functional.softplus(_randn(dev, B, T, H, seed=seed + 1))
    A = -torch.exp(_randn(dev, H, seed=seed + 2) * 0.3)
    # B and C as the two halves of one packed projection, as in zamba2
    bc = (_randn(dev, B, T, G, 2 * N, seed=seed + 3) * 0.4).to(dtype)
    D = 1 + 0.1 * _randn(dev, H, seed=seed + 4)
    return x, dt, A, bc[..., :N], bc[..., N:], D


def _rms_rel(got, want):
    e, w = got.float() - want.float(), want.float()
    return (e.pow(2).mean().sqrt() / w.pow(2).mean().sqrt()).item()


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(dev, B, T, H, P, G, N, chunk, dtype):
    """The forward in both dtypes (fp32 counted in `launches_f32` too);
    chunks of 12 and 16 rows (T 12 at chunk 16, T 24 at chunk 16), ragged
    last chunks (T 300 at 128), B and C strided halves of one projection,
    N of 12 and 5 (element loads)."""
    ins = _ssd_inputs(dev, B, T, H, P, G, N, dtype)
    bf16 = dtype == torch.bfloat16
    n, n32 = ssd_ops.launches, ssd_ops.launches_f32
    got = ssd_ops.ssd(*ins, chunk=chunk)
    assert (ssd_ops.launches, ssd_ops.launches_f32) == \
        (n + 1, n32 if bf16 else n32 + 1) and got.dtype == dtype
    want, _ = ssd_ref.ssd_chunked(*ins, chunk=chunk)
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL if bf16 else TOL32))
    if bf16:
        assert _rms_rel(got, want) <= SSD_BF16_RMS_REL
    # without the D skip
    torch.testing.assert_close(
        ssd_ops.ssd(*ins[:5], None, chunk).float(),
        ssd_ref.ssd_chunked(*ins[:5], None, chunk)[0].float(),
        **(TOL if bf16 else TOL32))


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_bf16_forward_keeps_the_states_for_the_backward(
        dev, B, T, H, P, G, N, chunk):
    """The state entering each chunk, as the bf16 forward saves it, against
    the plain `ssd_chunk_states`."""
    ins = _ssd_inputs(dev, B, T, H, P, G, N, torch.bfloat16)
    _, states, _ = ssd_ops._forward(*ins, chunk)
    want, _ = ssd_ref.ssd_chunk_states(*ins[:5], chunk=chunk)
    assert states.shape == want.shape
    torch.testing.assert_close(states, want, **TOL32)


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_fp32_forward_keeps_the_states_for_the_backward(
        dev, B, T, H, P, G, N, chunk):
    """The same for the fp32 forward, which now saves them too."""
    ins = _ssd_inputs(dev, B, T, H, P, G, N, torch.float32)
    _, states, _ = ssd_ops._forward(*ins, chunk)
    want, _ = ssd_ref.ssd_chunk_states(*ins[:5], chunk=chunk)
    torch.testing.assert_close(states, want, **TOL32)


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_final_state_matches_plain(dev, B, T, H, P, G, N, chunk, dtype):
    """`ssd_with_state`'s (y, S) against the plain `ssd_chunked`: S at
    TOL32 (bf16 inputs too: S is fp32 from the same bf16 values); the state
    entering the last chunk in its place must fail where there are two
    chunks or more."""
    ins = _ssd_inputs(dev, B, T, H, P, G, N, dtype)
    n = ssd_ops.launches
    y, S = ssd_ops.ssd_with_state(*ins, chunk=chunk)
    assert ssd_ops.launches == n + 1
    want_y, want_S = ssd_ref.ssd_chunked(*ins, chunk=chunk)
    assert S.shape == (B, H, P, N) and S.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(),
                               **(TOL32 if dtype == torch.float32 else TOL))
    torch.testing.assert_close(S, want_S, **TOL32)
    if T > chunk:
        _, states, _ = ssd_ops._forward(*ins, chunk)
        assert not torch.allclose(states[:, :, -1], want_S, **TOL32)


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_fp32_forward_with_one_tf32_product_misses_tol32(
        dev, B, T, H, P, G, N, chunk):
    """The planted fault: one TF32 product (hi * hi) in place of three
    must miss the tolerance the kernel holds."""
    ins = _ssd_inputs(dev, B, T, H, P, G, N, torch.float32)
    want, _ = ssd_ref.ssd_chunked(*ins, chunk=chunk)
    torch.testing.assert_close(ssd_ops.ssd_cuda(*ins, chunk=chunk), want,
                               **TOL32)
    planted = ssd_ops.ssd_cuda(*ins, chunk=chunk, tf32_products=1)
    assert not torch.allclose(planted, want, **TOL32)


def _ssd_ct(dev, B, T, H, P, dtype):
    return _randn(dev, B, T, H, P, dtype=dtype, seed=9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_gradient_matches_plain_autograd(dev, dtype):
    ins = _ssd_inputs(dev, 2, 40, 4, 16, 1, 8, dtype)
    ct = _ssd_ct(dev, 2, 40, 4, 16, dtype)
    n, nb = ssd_ops.launches, ssd_ops.bwd_launches
    n32 = ssd_ops.bwd_launches_f32
    got = _grads(lambda *a: ssd_ops.ssd(*a, chunk=16), ins, ct)
    assert (ssd_ops.launches, ssd_ops.bwd_launches) == (n + 1, nb + 1)
    assert ssd_ops.bwd_launches_f32 == n32 + (dtype == torch.float32)
    want = _grads(lambda *a: ssd_ref.ssd_chunked(*a, chunk=16)[0], ins, ct)
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a.float(), b.float(), **(TOL32 if dtype == torch.float32 else TOL))


GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


def _close_grads(got, want, tol, terms=None):
    """Elementwise `tol`, dA and dD (sums over B*T*P terms that cancel)
    relative to their array's largest |value| as tests/test_torch_ssd.py
    does; or, given `terms` (`ref.ssd_grad_terms`), tol's rtol applied to
    the summed |terms| of each element: fp32 sums taken in two orders
    differ by the rounding of their terms, not of their result."""
    for i, (name, a, b) in enumerate(zip(GRAD_NAMES, got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = (a.float() - b.float()).abs()
        if terms is not None:
            lim = tol["atol"] + tol["rtol"] * terms[i]
            assert (err <= lim).all(), (
                f"{name}: max err / limit {(err / lim).max().item():.3f}")
            continue
        scale = max(1.0, b.float().abs().max().item()) \
            if name in ("dA", "dD") else 1.0
        torch.testing.assert_close(a.float() / scale, b.float() / scale,
                                   msg=lambda m: f"{name}: {m}", **tol)


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_matches_plain(dev, B, T, H, P, G, N, chunk,
                                           dtype):
    """The backward kernels, given the forward's states, against the plain
    reverse-pass backward and against autograd through the plain chunk
    loop; then recomputing the states, without D."""
    ins = _ssd_inputs(dev, B, T, H, P, G, N, dtype)
    ct = _ssd_ct(dev, B, T, H, P, dtype)
    fp32 = dtype == torch.float32
    tol = TOL32 if fp32 else TOL
    terms = ssd_ref.ssd_grad_terms(*ins, ct, chunk) if fp32 else None
    _, states, _ = ssd_ops._forward(*ins, chunk)
    nb = ssd_ops.bwd_launches
    got = ssd_ops.ssd_bwd_cuda(*ins, ct, chunk, states=states)
    assert ssd_ops.bwd_launches == nb + 1
    _close_grads(got, ssd_ref.ssd_chunked_bwd(*ins, ct, chunk), tol, terms)
    _close_grads(got, _grads(lambda *a: ssd_ref.ssd_chunked(
        *a, chunk=chunk)[0], ins, ct)[1:], tol, terms)
    # without D: no dD
    got = ssd_ops.ssd_bwd_cuda(*ins[:5], None, ct, chunk)
    assert got[5] is None
    _close_grads(got[:5], ssd_ref.ssd_chunked_bwd(*ins[:5], None, ct,
                                                  chunk)[:5], tol,
                 None if terms is None else ssd_ref.ssd_grad_terms(
                     *ins[:5], None, ct, chunk)[:5])


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SSD_SHAPES + [
    (1, 256, 48, 64, 1, 64, 128), (1, 256, 24, 32, 2, 64, 128)])
def test_ssd_bf16_backward_kernel_within_its_rms_limit(dev, B, T, H, P, G, N,
                                                       chunk):
    """The bf16 chunk gradients (csrc/ssd_bwd_sm90.cu), given the forward's
    states: at TOL, and dx, ddt, dB and dC within SSD_BF16_GRAD_RMS_REL of
    the plain reverse-pass backward where the gradient has 2048 elements or
    more; two calls bit-identical.  The RMS limit needs that many: outputs
    are bf16, and two fp32 sums in different orders round to different bf16
    values on ~2^-8 of the elements, one ulp (2^-8 to 2^-7 of the value)
    each, so one such flip on the 384-element dC of (2, 24, 8, 16, 1, 8, 16)
    reads ~6e-4 alone.  The last two shapes take three blocks of 16 heads
    (H 48) and blocks of 4 heads (H / G 12)."""
    ins = _ssd_inputs(dev, B, T, H, P, G, N, torch.bfloat16)
    ct = _ssd_ct(dev, B, T, H, P, torch.bfloat16)
    _, states, _ = ssd_ops._forward(*ins, chunk)
    got = ssd_ops.ssd_bwd_cuda(*ins, ct, chunk, states=states)
    again = ssd_ops.ssd_bwd_cuda(*ins, ct, chunk, states=states)
    for name, a, b in zip(GRAD_NAMES, got, again):
        assert torch.equal(a, b), name
    want = ssd_ref.ssd_chunked_bwd(*ins, ct, chunk)
    _close_grads(got, want, TOL)
    for i, name in ((0, "dx"), (1, "ddt"), (3, "dB"), (4, "dC")):
        if want[i].numel() >= 2048:
            assert _rms_rel(got[i], want[i]) <= SSD_BF16_GRAD_RMS_REL, name


def test_ssd_bf16_backward_kernel_with_one_bf16_part_misses_its_limit(dev):
    """The planted fault inside the kernel: M and the heads' dCB sum in one
    bf16 part (`bf16_parts=1`) must miss SSD_BF16_GRAD_RMS_REL on dx, ddt,
    dB and dC."""
    ins = _ssd_inputs(dev, 2, 512, 16, 64, 1, 64, torch.bfloat16)
    ct = _ssd_ct(dev, 2, 512, 16, 64, torch.bfloat16)
    want = ssd_ref.ssd_chunked_bwd(*ins, ct, 128)
    planted = ssd_ops.ssd_bwd_cuda(*ins, ct, 128, bf16_parts=1)
    for i, name in ((0, "dx"), (1, "ddt"), (3, "dB"), (4, "dC")):
        assert _rms_rel(planted[i], want[i]) > SSD_BF16_GRAD_RMS_REL, name
    with pytest.raises(ValueError, match="bf16_parts"):
        ssd_ops.ssd_bwd_cuda(*ins, ct, 128, bf16_parts=3)
    with pytest.raises(ValueError, match="bf16_parts"):
        ssd_ops.ssd_bwd_cuda(*(t.float() for t in ins), ct.float(), 128,
                             bf16_parts=1)


def test_ssd_backward_needs_its_reverse_state_pass(dev):
    """A backward with the reverse state pass dropped (dS_out = 0, the
    plain chunk grads given zeros) must fail the check the kernel passes."""
    ins = _ssd_inputs(dev, 1, 64, 2, 16, 1, 8, torch.float32)
    ct = _ssd_ct(dev, 1, 64, 2, 16, torch.float32)
    want = ssd_ref.ssd_chunked_bwd(*ins, ct, 16)
    terms = ssd_ref.ssd_grad_terms(*ins, ct, 16)
    _close_grads(ssd_ops.ssd_bwd_cuda(*ins, ct, 16), want, TOL32, terms)
    states, _ = ssd_ref.ssd_chunk_states(*ins[:5], chunk=16)
    dstates = ssd_ref.ssd_chunk_dstates(ct, ins[1], ins[2], ins[4], 16)
    dropped = ssd_ref.ssd_chunk_grads(*ins, ct, states,
                                      torch.zeros_like(dstates), 16)
    with pytest.raises(AssertionError):
        _close_grads(dropped, want, TOL32, terms)


def test_ssd_kernel_carries_the_state_across_chunks(dev):
    """Dropping the carried state (each chunk from S = 0) must fail the
    check the kernel passes."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(dev, 1, 64, 2, 16, 1, 8, torch.float32)
    got = ssd_ops.ssd(x, dt, A, Bm, Cm, D, 16)
    want, _ = ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, D, 16)
    torch.testing.assert_close(got, want, **TOL32)
    stateless = torch.cat([ssd_ref.ssd_chunked(
        x[:, i:i + 16], dt[:, i:i + 16], A, Bm[:, i:i + 16], Cm[:, i:i + 16],
        D, 16)[0] for i in range(0, 64, 16)], dim=1)
    assert not torch.allclose(stateless, want, **TOL32)


def test_ssd_kernel_rejects_what_it_does_not_take(dev):
    x, dt, A, Bm, Cm, D = _ssd_inputs(dev, 1, 32, 2, 16, 1, 8, torch.float32)
    with pytest.raises(TypeError):
        ssd_ops.ssd_cuda(x.half(), dt, A, Bm.half(), Cm.half(), D)
    with pytest.raises(TypeError):
        ssd_ops.ssd_cuda(x, dt, A, Bm.bfloat16(), Cm.bfloat16(), D)
    with pytest.raises(ValueError, match="P 24"):
        ssd_ops.ssd_cuda(x[..., :12].repeat(1, 1, 1, 2), dt, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd_cuda(x, dt, A, Bm, Cm, D, chunk=0)
    with pytest.raises(ValueError, match="unit stride"):
        ssd_ops.ssd_cuda(x.transpose(2, 3).contiguous().transpose(2, 3),
                         dt, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="line up"):
        ssd_ops.ssd_cuda(x, dt[:, :-1], A, Bm, Cm, D)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_ops.ssd_cuda(x, dt.cpu(), A, Bm, Cm, D)
    with pytest.raises(ValueError, match="dy"):
        ssd_ops.ssd_bwd_cuda(x, dt, A, Bm, Cm, D, x[:, :-1])
    with pytest.raises(ValueError, match="tf32_products"):
        ssd_ops.ssd_cuda(x, dt, A, Bm, Cm, D, tf32_products=2)
    with pytest.raises(ValueError, match="states"):
        ssd_ops.ssd_bwd_cuda(x, dt, A, Bm, Cm, D, x, 16,
                             states=torch.zeros(1, 2, 1, 16, 8, device=dev))
