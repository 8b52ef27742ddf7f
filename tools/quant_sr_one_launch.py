#!/usr/bin/env python3
"""Times the SR quantizer as one cooperative launch
(tools/quant_sr_one_launch.cu) against the shipped seed pass + quant kernel
(src/repro_torch/csrc/quant.cu), on one CUDA card:

    python3 tools/quant_sr_one_launch.py      # from the root of a checkout

At the largest bucket of qwen3-1.7b's full-width prefetch path (37,750,784
elements), f32 / bf16 x fp8 / int8, SR: both are held bit for bit to the
plain version (wire bytes, scales, the seed), then timed on the device
(torch.profiler, as chip_smoke.py's device_ms), shipped / one launch /
shipped / one launch.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

N = 37_750_784


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.library()
    out = build.BUILD_DIR / "quant_sr_one_launch.so"
    t0 = time.perf_counter()
    log = build._run_all([[build._nvcc(), *build.CFLAGS, "-I",
                           str(build.CSRC), "-shared", "-o", str(out),
                           str(ROOT / "tools" / "quant_sr_one_launch.cu")]])
    print(f"built in {time.perf_counter() - t0:.1f}s")
    for name, regs, smem, spills in cs._kernel_resources(log):
        if "one_kernel" in name:
            print(f"  {name}: {regs} registers, spills {spills}")
    lib = ctypes.CDLL(str(out))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    one = lib.quant_sr_one_launch
    one.argtypes = [p, i, ll, i, f, f, p, p, p, i, p, i, p]
    one.restype = i
    lib.quant_sr_one_plan.argtypes = [i, i, p, p]
    lib.quant_sr_one_plan.restype = i
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def one_launch(x, codec, seed):
        blocks, kept = ctypes.c_int(), ctypes.c_longlong()
        build.check(lib.quant_sr_one_plan(qops._DTYPES[x.dtype], sms,
                                          ctypes.byref(blocks),
                                          ctypes.byref(kept)), "plan")
        m = math.ceil(x.numel() / qref.QCHUNK)
        q = torch.empty((m, qref.QCHUNK), dtype=qref.WIRE_DTYPE[codec],
                        device=x.device)
        s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
        part = torch.empty(blocks.value, dtype=torch.int32, device=x.device)
        qmax = qref.QMAX[codec]
        build.check(one(x.data_ptr(), qops._DTYPES[x.dtype], x.numel(),
                        qops._CODECS[codec], qmax, 1.0 / qmax, q.data_ptr(),
                        s.data_ptr(), part.data_ptr(), blocks.value,
                        seed.data_ptr(), sms, build.stream_ptr(x.device)),
                    "quant_sr_one_launch")
        return q, s, kept.value

    print(f"SR at n={N} (device ms: shipped / one launch / shipped / one "
          "launch):")
    for dt in (torch.float32, torch.bfloat16):
        for codec in ("fp8", "int8"):
            x = cs._codec_input(N, dt, seed=3)
            seed = torch.empty(1, dtype=torch.int32, device="cuda")
            q, s, kept = one_launch(x, codec, seed)
            wq, ws = qref.quantize(x, codec, True)
            cs.check_exact("one launch wire bytes", q.view(torch.uint8),
                           wq.view(torch.uint8))
            cs.check_exact("one launch scales", cs._bits(s), cs._bits(ws))
            cs.check_exact("one launch seed", torch.tensor(
                int(seed.item()) & qref.M32), torch.tensor(
                int(qref.buffer_seed(qref.chunk(x)[0]))))
            shipped = lambda: qops.quantize_cuda(x, codec, True)
            single = lambda: one_launch(x, codec, seed)
            times = [cs.device_ms(fn) for fn in (shipped, single, shipped,
                                                 single)]
            print(f"  {str(dt)[6:]} {codec}: "
                  + " / ".join(cs._ms(t) for t in times)
                  + f" (exact; one launch keeps {kept} elements on chip)",
                  flush=True)
            del x, q, s, wq, ws
    return 0


if __name__ == "__main__":
    sys.exit(main())
