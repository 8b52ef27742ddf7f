"""Builds the hand-written CUDA kernels (`repro_torch/csrc/*.cu`) into one
shared library with `nvcc` and loads it with `ctypes`.

The sources have a plain C interface and include no PyTorch header, so a
build takes seconds.  Every source compiles in its own `nvcc` process, all
started together, and one link step joins the objects.  The library is named
by a hash of the sources and flags, under `build/repro_torch/` at the root
of the checkout, so a changed source always rebuilds.  Nothing here runs at
import: the first CUDA launch calls `library()`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# sm_90a keeps wgmma/setmaxnreg available to later kernels.
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v", *ARCH]

# dtype codes of the C interface (csrc/common.cuh)
F32, BF16 = 0, 1


@dataclasses.dataclass(frozen=True)
class Library:
    cdll: ctypes.CDLL
    path: Path
    seconds: float        # build wall time (0.0 when an up-to-date build was found)
    log: str              # nvcc/ptxas output (registers, shared memory,
                          # spills), kept beside the library for later loads


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "repro_torch kernels need nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _run_all(cmds: list[list[str]]) -> str:
    """Runs the commands concurrently; raises with their output if any
    fails.  Returns the combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(
            " ".join(c) + "\n" + o for c, o in failed))
    return "".join(outs)


def build() -> tuple[Path, float, str]:
    """Compiles and links the library unless an up-to-date one exists."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha1(" ".join(CFLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode() + f.read_bytes())
    out = BUILD_DIR / f"librepro_torch_kernels-{digest.hexdigest()[:12]}.so"
    saved = out.with_suffix(".log")
    if out.exists():
        old = saved.read_text() if saved.exists() else ""
        return out, 0.0, "up-to-date build found; nothing compiled\n" + old
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    log = _run_all([[nvcc, *CFLAGS, "-c", str(s), "-o", str(o)]
                    for s, o in zip(sources, objs)])
    tmp = out.with_suffix(f".{tag}.tmp")
    log += _run_all([[nvcc, "-shared", *ARCH, "-o", str(tmp),
                      *map(str, objs)]])
    saved.write_text(log)
    os.replace(tmp, out)
    for o in objs:
        o.unlink()
    return out, time.perf_counter() - t0, log


@functools.cache
def library() -> Library:
    path, seconds, log = build()
    cdll = ctypes.CDLL(str(path))
    cdll.repro_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.repro_cuda_error_string.restype = ctypes.c_char_p
    return Library(cdll, path, seconds, log)


def check(rc: int, what: str) -> None:
    """Raises on a non-zero cudaError_t returned by a launcher."""
    if rc:
        name = library().cdll.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({name})")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current CUDA stream on `device` (a CUDA tensor's device),
    as the address a launcher takes.  Read on every call, as PyTorch keeps
    it: a `torch.cuda.Stream` object costs more host time than the small
    kernels it launches."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
