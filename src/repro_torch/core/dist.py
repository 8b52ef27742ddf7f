"""Distributed configuration (subset of `repro.core.dist`), device choice
and the process group the FSDP collectives run on.

One frozen `DistConfig` flows through the port, as in the reference.  It
carries the fields the serving path and the pp=1 FSDP training path read:
the (data, model) mesh, the ZeRO-3 domain, the mixed-precision dtypes, the
SimpleFSDP schedule knobs (bucketing, the prefetch stack and its Table-6
flags), the auto-wrap memory cap, the wire precision of the collectives
and the storage codec of the serving KV cache.  What the port does not
run yet raises a pointed "not yet ported" error (`check_trainable`):
tp > 1, pipeline or context axes and HSDP replication axes.
`make_mesh` checks (or, at world size 1, creates) the `torch.distributed`
process group the FSDP collectives run on.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

TP_AXIS = "model"

# Wire-precision vocabulary of the bucket collectives (the reference's
# `repro.core.dist`): 'bf16' is uncompressed; '*_ag' quantizes the param
# all-gathers only (RTN); 'fp8' / 'int8' add a stochastically rounded grad
# reduce-scatter; '*_ef' add the error-feedback accumulator in the
# optimizer state; 'auto' lets the bucket planner pick from AUTO_PRECISIONS
# per bucket (`core/autowrap`).
COMM_PRECISIONS = ("bf16", "fp8_ag", "fp8", "fp8_ef",
                   "int8_ag", "int8", "int8_ef", "auto")
AUTO_PRECISIONS = ("bf16", "fp8_ag", "fp8_ef", "int8_ag", "int8_ef")


def precision_codecs(precision: str) -> tuple[str | None, str | None]:
    """(all-gather codec, reduce-scatter codec) of one RESOLVED precision;
    None means uncompressed."""
    return {
        "bf16": (None, None),
        "fp8_ag": ("fp8", None),
        "fp8": ("fp8", "fp8"),
        "fp8_ef": ("fp8", "fp8"),
        "int8_ag": ("int8", None),
        "int8": ("int8", "int8"),
        "int8_ef": ("int8", "int8"),
    }[precision]


@dataclasses.dataclass(frozen=True)
class DistConfig:
    # Mesh: the model axis is the tensor-parallel one
    mesh_axes: tuple[str, ...] = ("data", "model")
    mesh_shape: tuple[int, ...] = (1, 1)
    # ZeRO-3 sharding domain for parameters, gradients and optimizer state
    fsdp_axes: tuple[str, ...] = ("data",)

    # Mixed precision (paper SS4)
    param_dtype: torch.dtype = torch.bfloat16    # forward/backward compute
    reduce_dtype: torch.dtype = torch.float32    # gradient reduce-scatter
    storage_dtype: torch.dtype = torch.float32   # sharded master weights
    # cast to param_dtype BEFORE the all-gather (halves the gathered bytes)
    gather_in_param_dtype: bool = True

    # SimpleFSDP schedule knobs (paper SS3.2, Tables 5/6)
    # 'none' | 'block' | 'auto' (greedy Alg. 1) | 'auto_dp' (the
    # exposure-minimizing DP, core/autowrap.py) | a BucketPlan
    bucket_mode: object = "block"
    reorder: bool = True               # the bucket+reorder prefetch stack
    # pipeline the prefetch per block segment (attn / mlp); off = one
    # whole-layer gather point per layer
    segment_prefetch: bool = True
    # Table 6: issue the prefetch all-gather before (True) or after (False)
    # the current segment's compute, in forward and backward
    ag_before_wait_fwd: bool = True
    ag_before_wait_bwd: bool = False
    # delay each bucket's reduce-scatter by one layer (paper: "Wr12 placed
    # before RS34")
    rs_delay: bool = True
    remat: str = "fsdp_only"           # core/remat.py vocabulary
    # auto-wrap memory cap (paper Alg. 1 M_max), bytes of prefetched params
    autowrap_mem_limit: float = 1.0 * 1024**3
    # reduce-scatter in bf16, accumulated in reduce_dtype afterwards
    grad_compression: bool = False
    comm_precision: str = "bf16"       # COMM_PRECISIONS
    # Quantized KV cache: serving caches and pages store wire-codec values
    # + per-128-chunk f32 scales (kernels/quant, the codec the quantized
    # collectives use).  'int8' | 'fp8' | None; the bool `kv_cache_int8`
    # is the reference's alias for 'int8'
    kv_cache_codec: str | None = None
    kv_cache_int8: bool = False
    microbatches: int = 1              # gradient accumulation

    def __post_init__(self):
        if self.comm_precision not in COMM_PRECISIONS:
            raise ValueError(f"comm_precision={self.comm_precision!r} not in "
                             f"{COMM_PRECISIONS}")
        if self.kv_cache_codec not in (None, "int8", "fp8"):
            raise ValueError(
                f"kv_cache_codec={self.kv_cache_codec!r} not in "
                f"(None, 'int8', 'fp8')")

    @property
    def kv_codec(self) -> str | None:
        """Resolved KV-cache wire codec (kernels/quant vocabulary)."""
        return self.kv_cache_codec or ("int8" if self.kv_cache_int8
                                       else None)

    @property
    def needs_ef(self) -> bool:
        """Whether the optimizer state carries the error-feedback
        accumulator: the *_ef modes, and 'auto' (the planner may give any
        bucket an _ef precision)."""
        return self.comm_precision in ("fp8_ef", "int8_ef", "auto")

    def axis_size(self, name: str) -> int:
        return self.mesh_shape[self.mesh_axes.index(name)]

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh_axes, self.mesh_shape))

    @property
    def fsdp_size(self) -> int:
        return math.prod(self.axis_size(a) for a in self.fsdp_axes)

    @property
    def tp_size(self) -> int:
        return self.axis_size(TP_AXIS) if TP_AXIS in self.mesh_axes else 1

    @property
    def dp_total(self) -> int:
        """Data-parallel ways: every axis but the tensor-parallel one (the
        reduce-scatter divides by this for the global-batch mean)."""
        return math.prod(s for a, s in zip(self.mesh_axes, self.mesh_shape)
                         if a != TP_AXIS)

    @property
    def cp_size(self) -> int:
        """Context-parallel degree: the 'ctx' axis (1 without one)."""
        return self.axis_size("ctx") if "ctx" in self.mesh_axes else 1

    @property
    def batch_dp(self) -> int:
        """Batch-row sharding ways: dp_total without the ctx axis."""
        return self.dp_total // self.cp_size

    @property
    def n_devices(self) -> int:
        return math.prod(self.mesh_shape)

    def with_(self, **kw) -> "DistConfig":
        return dataclasses.replace(self, **kw)


def single_device_config(**kw) -> DistConfig:
    """A 1x1 mesh config — what the port serves on."""
    return DistConfig(mesh_shape=(1, 1), **kw)


def check_world_size_one(dcfg: DistConfig) -> None:
    """Serving entry points run at tp=1, dp=1 only (multi-rank is later)."""
    if dcfg.n_devices != 1:
        raise NotImplementedError(
            f"mesh {dcfg.mesh_shape}: the port serves on one device only "
            "(tp>1 / dp>1 serving is not ported yet)")


def check_trainable(dcfg: DistConfig) -> None:
    """Raises a pointed error for every training layout the port does not
    run yet; never degrades one into another."""
    if dcfg.tp_size > 1:
        raise NotImplementedError(
            f"tp={dcfg.tp_size}: tensor parallelism is not yet ported to "
            "repro_torch (train at tp=1)")
    for a, s in zip(dcfg.mesh_axes, dcfg.mesh_shape):
        if a in ("pipe", "ctx") and s > 1:
            raise NotImplementedError(
                f"{a} axis of size {s}: {'pp' if a == 'pipe' else 'cp'}>1 "
                "is not yet ported to repro_torch")
        if a != TP_AXIS and a not in dcfg.fsdp_axes and s > 1:
            raise NotImplementedError(
                f"axis {a!r} of size {s} replicates parameters (HSDP); "
                "not yet ported to repro_torch — put it in fsdp_axes")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and absent — never falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the FSDP process group (tp = pp = 1: every
    rank of the default group)."""
    rank: int
    size: int


def make_mesh(dcfg: DistConfig) -> Mesh:
    """Checks the process group the FSDP collectives run on and returns
    this rank's place in it.

    At world size 1 with no group yet, creates one on an in-process store
    (no network): gloo for CPU tensors and, where NCCL exists, NCCL for CUDA
    tensors, so one process can run on both devices.  A multi-rank mesh
    needs the caller to have called `torch.distributed.init_process_group`
    with the mesh's world size."""
    check_trainable(dcfg)
    if not dist.is_initialized():
        if dcfg.n_devices != 1:
            raise RuntimeError(
                f"mesh {dcfg.mesh_shape} needs {dcfg.n_devices} ranks: call "
                "torch.distributed.init_process_group(world_size="
                f"{dcfg.n_devices}, ...) in every rank first")
        backend = ("cpu:gloo,cuda:nccl" if dist.is_nccl_available()
                   else "gloo")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != dcfg.n_devices:
        raise ValueError(f"mesh {dcfg.mesh_shape} has {dcfg.n_devices} "
                         f"ranks, the process group {dist.get_world_size()}")
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size())
