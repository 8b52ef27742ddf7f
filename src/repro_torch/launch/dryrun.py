"""Measured planner inputs (port of one function of `repro.launch.dryrun`).

`harvest_quant_timing` times the wire codec's round trip at a plan's bucket
sizes and turns it into a measured codec rate, which `core/obs/calibrate`
installs in place of the analytic prior of `core/irgraph.quant_overhead_s`.
On the card it times the hand-written kernels (`csrc/quant.cu`, through
`kernels/quant/ops.roundtrip`); on the CPU their plain version.

The rest of the reference's dryrun (lowering every arch x shape x mesh
cell, harvested BlockStats, the memory calibration's `act_scale`) is not
yet ported.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.dist import resolve_device
from repro_torch.kernels.quant import ops as quant_ops


def elapsed_s(fn, n: int, device) -> float:
    """Seconds `n` back-to-back calls of `fn()` take: CUDA events on the
    current stream on the card (the device's time for the queued work),
    the host clock on the CPU.  No warm-up: callers make their own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return time.perf_counter() - t0


def harvest_quant_timing(bucket_elems, codec: str = "fp8", iters: int = 4,
                         cap_elems: int = 1 << 21,
                         device="cuda") -> dict | None:
    """Time the quant round trip at the plan's actual bucket sizes and
    derive a measured codec throughput.  `bucket_elems`: per-bucket element
    counts (each capped at `cap_elems` so a one-bucket plan does not
    allocate the full buffer).  Returns {"rate_bytes_per_s", "codec",
    "samples"}, or None when there is no bucket to time.

    Unlike the reference, a codec that fails to build or launch raises: it
    never quietly leaves the analytic prior standing."""
    dev = resolve_device(device)
    sizes = sorted({min(int(n), cap_elems)
                    for n in bucket_elems if n and n > 0})
    if not sizes:
        return None
    # smallest / median / largest: enough to see the fixed-cost knee
    # without timing every bucket of a 30-bucket plan
    picks = sorted({sizes[0], sizes[len(sizes) // 2], sizes[-1]})
    samples = []
    for n in picks:
        n = max(quant_ops.QCHUNK, (n // quant_ops.QCHUNK) * quant_ops.QCHUNK)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                             .astype(np.float32)).to(dev, torch.bfloat16)

        def call(x=x):
            return quant_ops.roundtrip(x, codec)

        call()                                      # build + warm-up
        dt = elapsed_s(call, iters, dev) / iters
        samples.append({"n_elems": n, "bytes": n * 2, "t_us": dt * 1e6})
    big = samples[-1]
    rate = big["bytes"] / max(1e-12, big["t_us"] * 1e-6)
    return {"rate_bytes_per_s": rate, "codec": codec, "samples": samples}
