#!/usr/bin/env python3
"""The flash-attention gradient's readings at the six bf16 shapes of
`chip_smoke.flash_grad_case` (qwen3-1.7b's layer B4 T2048 H16 Kh8 hd128
causal, qwen3-moe's group of 8 H32 Kh4, gemma2-27b's local layer B1 T8192
H32 Kh16 window 4096 softcap 50 q_scale 1/16, seamless-m4t-large-v2's hd 64
B4 T1024 H16 Kh16 non-causal and causal, internvl2-26b's group of 6 B2 T2048
H48 Kh8), for the checkout whose root is given:

    python3 tools/flash_grad_readings.py [ROOT]     # on the card; ROOT: .

Prints, per shape, fwd + bwd ms of the op (`ops.flash_attention` under
autograd), the plain version (autograd through `ref.attention`; by two kv
heads at T 8192), SDPA (without the softcap, a boolean mask under the window)
and the bound, then the backward alone: wall and device ms (CUDA events behind
a sleep kernel) of the op's and of SDPA's, beside the bound. It reads only
what every checkout since gemma2's port has (`ops`, `ref`, `chip_smoke`'s
timers, `_grads` and `_sdpa_fn`), so a parent checkout gives the "was" line:
run it as parent, change, change, parent in one call to compare the two.
Where the op's backward is slower than the sleep kernel covers, its device
reading fails and only the fwd + bwd line is printed.
"""
import sys
import traceback
from pathlib import Path

root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
sys.path[:0] = [str(root / "src"), str(root)]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

SHAPES = [  # (label, B, T, H, Kh, hd, kwargs, plain by kv heads)
    ("qwen3-1.7b B4 T2048 H16 Kh8 hd128 causal", 4, 2048, 16, 8, 128,
     dict(causal=True), False),
    ("qwen3-moe group 8 B4 T2048 H32 Kh4 hd128 causal", 4, 2048, 32, 4, 128,
     dict(causal=True), False),
    ("gemma2-27b local B1 T8192 H32 Kh16 hd128 window 4096 softcap 50 "
     "q_scale 1/16", 1, 8192, 32, 16, 128,
     dict(causal=True, window=4096, softcap=50.0, q_scale=1 / 16), True),
    ("seamless-m4t-large-v2 B4 T1024 H16 Kh16 hd64 non-causal", 4, 1024, 16,
     16, 64, dict(causal=False), False),
    ("seamless-m4t-large-v2 B4 T1024 H16 Kh16 hd64 causal", 4, 1024, 16, 16,
     64, dict(causal=True), False),
    ("internvl2-26b group 6 B2 T2048 H48 Kh8 hd128 causal", 2, 2048, 48, 8,
     128, dict(causal=True), False),
]


def readings(label, b, s, h, kh, hd, kw, by_heads, g):
    print(f"== {label}", flush=True)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v, ct = randn(b, s, h, hd), randn(b, s, kh, hd), \
        randn(b, s, kh, hd), randn(b, s, h, hd)
    pairs = C._attn_pairs(s, kw.get("window")) if kw["causal"] else s * s
    bound, _ = C._bound(0, 3.5 * 4.0 * hd * b * h * pairs, torch.bfloat16,
                        products=True)
    bwd_bound = bound * 2.5 / 3.5
    op = lambda: C._grads(lambda *a: ops.flash_attention(*a, **kw),
                          (q, k, v), ct)
    if by_heads:
        plain = lambda: C._by_kv_heads(lambda qq, kk, vv, cc: C._grads(
            lambda *a: ref.attention(*a, **kw), (qq, kk, vv), cc),
            q, k, v, ct)
    else:
        plain = lambda: C._grads(lambda *a: ref.attention(*a, **kw),
                                 (q, k, v), ct)
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    sd = C._sdpa_fn(*leaves, kw.get("window"), kw.get("q_scale"),
                    causal=kw["causal"])
    ctt = ct.transpose(1, 2)
    print(f"  fwd+bwd ms op / plain / SDPA / bound: {C.time_ms(op):.4f} / "
          f"{C.time_ms(plain):.4f} / "
          f"{C.time_ms(lambda: sd().backward(ctt)):.4f} / {bound:.4f}",
          flush=True)
    out, so = ops.flash_attention(*leaves, **kw), sd()
    bwd = lambda: torch.autograd.grad(out, leaves, ct, retain_graph=True)
    sbwd = lambda: torch.autograd.grad(so, leaves, ctt, retain_graph=True)
    print(f"  bwd alone ms op {C.time_ms(bwd):.4f} (device "
          f"{C.device_ms(bwd, bwd_bound, n=10):.4f}) / SDPA "
          f"{C.time_ms(sbwd):.4f} (device "
          f"{C.device_ms(sbwd, bwd_bound, n=10):.4f}) / bound "
          f"{bwd_bound:.4f}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("flash_grad_readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        try:
            readings(*shape, g)
        except AssertionError:
            traceback.print_exc()
        torch.cuda.empty_cache()
    print(C.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
