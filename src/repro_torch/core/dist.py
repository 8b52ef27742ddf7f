"""Distributed configuration (subset of `repro.core.dist`), device choice
and the process group the FSDP collectives run on.

One frozen `DistConfig` flows through the port, as in the reference.  It
carries the fields the serving path and the pp=1 FSDP training path read:
the (data, model) mesh, the ZeRO-3 domain, the mixed-precision dtypes and
the SimpleFSDP schedule knobs.  What the port does not run yet raises a
pointed "not yet ported" error (`check_trainable`): tp > 1, pipeline or
context axes, HSDP replication axes, and any `comm_precision` but "bf16".
`make_mesh` checks (or, at world size 1, creates) the `torch.distributed`
process group the FSDP collectives run on.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

TP_AXIS = "model"


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

    # SimpleFSDP schedule knobs (paper SS3.2)
    bucket_mode: object = "block"      # 'none' | 'block' | a BucketPlan
    reorder: bool = True               # prefetch stack: not yet ported
    remat: str = "fsdp_only"           # core/remat.py vocabulary
    comm_precision: str = "bf16"       # quantized collectives: not ported
    microbatches: int = 1              # gradient accumulation

    def axis_size(self, name: str) -> int:
        return self.mesh_shape[self.mesh_axes.index(name)]

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
    if dcfg.comm_precision != "bf16":
        raise NotImplementedError(
            f"comm_precision={dcfg.comm_precision!r}: quantized collectives "
            "are not yet ported to repro_torch (ROADMAP item 8); use 'bf16'")


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
