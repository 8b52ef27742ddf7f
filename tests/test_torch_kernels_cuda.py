"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device.  This file imports
only torch and the port, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

chip_smoke.py holds the kernels against their plain versions at the
serving path's full shapes; these are small, quick cases.  Tolerances:
TOL32 (rtol 2e-4, atol 2e-5) for fp32, TOL (2e-2) for bf16.
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops, \
    ref as flash_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops, ref as rms_ref

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("rows,d", [(8, 128), (9, 384), (33, 4096),
                                    (5, 7168), (7, 100)])
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


@pytest.mark.parametrize("S,H,Kh,hd", [(64, 2, 2, 16), (200, 4, 2, 64),
                                       (130, 8, 2, 128), (1, 4, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=33, softcap=30.0)])
def test_flash_kernel_matches_plain(dev, S, H, Kh, hd, dtype, kw):
    q = _randn(dev, 2, S, H, hd, dtype=dtype)
    k = _randn(dev, 2, S, Kh, hd, dtype=dtype, seed=1)
    v = _randn(dev, 2, S, Kh, hd, dtype=dtype, seed=2)
    n = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, **kw)
    assert flash_ops.launches == n + 1
    want = flash_ref.attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL32 if dtype == torch.float32 else TOL))


def test_flash_kernel_reads_strided_heads(dev):
    qkv = _randn(dev, 2, 77, 12, 64, dtype=torch.bfloat16)
    q, k, v = qkv.split([8, 2, 2], dim=2)
    torch.testing.assert_close(flash_ops.flash_attention(q, k, v).float(),
                               flash_ref.attention(q, k, v).float(), **TOL)


def test_flash_kernel_rejects_unsupported_head_dim(dev):
    q = _randn(dev, 1, 8, 2, 32)
    with pytest.raises(ValueError, match="hd"):
        flash_ops.flash_attention(q, q, q)
