"""Distributed configuration (subset of `repro.core.dist`) and device choice.

The port serves at world size 1.  `DistConfig` keeps the (data, model) mesh
shape because the attention layout (`ArchConfig.gqa_layout`, the head mask)
is a function of the tensor-parallel degree; the serving entry points raise
on any mesh larger than one device.  There is no mesh object yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class DistConfig:
    # (data, model): the model axis is the tensor-parallel one
    mesh_shape: tuple[int, int] = (1, 1)
    # forward compute / serving weight and KV-cache dtype
    param_dtype: torch.dtype = torch.bfloat16

    @property
    def tp_size(self) -> int:
        return self.mesh_shape[1]

    @property
    def n_devices(self) -> int:
        return math.prod(self.mesh_shape)


def single_device_config(**kw) -> DistConfig:
    """A 1x1 mesh config — what the port serves on."""
    return DistConfig(mesh_shape=(1, 1), **kw)


def check_world_size_one(dcfg: DistConfig) -> None:
    """Serving entry points run at tp=1, dp=1 only (multi-rank is later)."""
    if dcfg.n_devices != 1:
        raise NotImplementedError(
            f"mesh {dcfg.mesh_shape}: the port serves on one device only "
            "(tp>1 / dp>1 serving is not ported yet)")


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
