#!/usr/bin/env python3
"""The SSD kernels' readings at zamba2-1.2b's layer shape (B 4, T 2048, H 64,
P 64, N 64, chunk 128, the model's own dt and A ranges; `chip_smoke.py`'s
phase 6a inputs), for the checkout whose root is given:

    python3 tools/ssd_readings.py [ROOT] [--step]    # on the card; ROOT: .

Prints the card's name and power limit, then, in fp32 and in bf16, the ms
of the forward (`ops.ssd_cuda`), of the backward recomputing the states
(`ops.ssd_bwd_cuda` without them) and of the op's forward + backward under
autograd, by CUDA events; then each kernel's device ms in one forward and
in one backward given the forward's states (torch.profiler): the reverse
scan, the chunk gradients and the group sum.  `--step` also trains
zamba2-1.2b at full width through the checkout's `chip_smoke` (B 4, T 2048,
the prefetch stack, 6 timed steps) and prints the median step ms and the
peak memory.  It reads only what every checkout since the SSD's
chunk-parallel forward has (`ops.ssd`, `ssd_cuda`, `ssd_bwd_cuda`,
`_forward`, `chip_smoke`'s `_ssd_inputs` and `phase_full_zamba_train`), so
a parent checkout gives the "was" line: run parent, change, change, parent
in one call.
"""
import re
import sys
from pathlib import Path

args = [a for a in sys.argv[1:] if a != "--step"]
root = Path(args[0] if args else ".").resolve()
sys.path[:0] = [str(root / "src"), str(root)]

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels.ssd import ops  # noqa: E402

B, T, H, P, G, N, LC = 4, 2048, 64, 64, 1, 64, 128
KERNEL = re.compile(r"(\w+_kernel(?:<[^>]*>)?)")


def events_ms(fn, n):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def kernels(label, fn, n=10):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    print(f"  {label}: " + "; ".join(
        f"{_name(e.key)} {e.self_device_time_total / n / 1e3:.4f} ms"
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)),
        flush=True)


def _name(key):
    """A kernel's name and template arguments from a profiler key."""
    m = KERNEL.search(key)
    return m.group(1) if m else key[:40]


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(C.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip())
    print(f"checkout {root}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        ins = C._ssd_inputs(g, B, T, H, P, G, N, dtype, True)
        ct = torch.randn((B, T, H, P), generator=g, device="cuda").to(dtype)
        xg = ins[0].clone().requires_grad_()
        fwd = events_ms(lambda: ops.ssd_cuda(*ins, chunk=LC), 20)
        bwd = events_ms(lambda: ops.ssd_bwd_cuda(*ins, ct, LC), 10)
        both = events_ms(lambda: torch.autograd.grad(
            ops.ssd(xg, *ins[1:], chunk=LC), xg, ct), 10)
        print(f"{str(dtype)[6:]}: forward {fwd:.4f} ms, backward recomputing "
              f"the states {bwd:.4f} ms, forward + backward {both:.4f} ms",
              flush=True)
        states = ops._forward(*ins, LC)[1]
        kernels("forward", lambda: ops.ssd_cuda(*ins, chunk=LC))
        kernels("backward given the states", lambda: ops.ssd_bwd_cuda(
            *ins, ct, LC, states=states), 5)
        del ins, ct, xg, states
        torch.cuda.empty_cache()
    if "--step" in sys.argv:
        state = {}
        C.phase_full_zamba_train(state)
        r = state["train_zamba2"]
        print(f"zamba2-1.2b prefetch step (B4 T2048): median "
              f"{r['step_ms']:.2f} ms, peak "
              f"{r['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)


if __name__ == "__main__":
    main()
