"""Hardware model the planners price work with (port of `repro.core.hw`).

The bucket planners (`core/autowrap`, `core/irgraph`) and the memory plan
(`core/memory`) never time anything: they price collectives, compute and
host copies with an alpha + beta model over the constants of one
`HardwareProfile`.  Two profiles exist:

  * `H100` — the port's default: nominal datasheet figures of one NVIDIA
    H100 80GB HBM3 (SXM5, 700 W) in an 8-GPU NVLink node, nodes joined by
    NDR InfiniBand.  The alphas are nominal and unmeasured; a calibration
    from profiled steps replaces them later;
  * `TPU_V5E` — the reference's constants, kept so that tests can demand
    plans equal to the reference's under its own profile.

`use_profile(p)` swaps the active profile for the duration of a ``with``
block.  Every function here reads the active profile when it is called.
"""

from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Per-device rates and sizes, and the collective bandwidth of the two
    kinds of mesh axis: ``pod`` (between nodes) and every other (inside a
    node)."""

    name: str
    peak_flops_bf16: float      # FLOP/s, dense bf16 matrix products
    hbm_bandwidth: float        # bytes/s
    hbm_bytes: float            # device memory
    intra_bw: float             # bytes/s a ring collective gets on one axis
    intra_alpha_s: float        # base latency of one collective on it
    inter_bw: float             # the same on the 'pod' axis
    inter_alpha_s: float
    host_dma_bw: float          # device <-> host DRAM, per direction
    host_dma_alpha_s: float


# The reference's TPU v5e constants (`repro/core/hw.py`): 197 TFLOP/s bf16,
# 819 GB/s HBM, 16 GiB; a ring on one torus dimension rides 2 of the 4 ICI
# links at 50 GB/s each; DCN 6.25 GB/s per host between pods; PCIe host DMA
# 32 GB/s.
TPU_V5E = HardwareProfile(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    hbm_bytes=16 * 1024**3,
    intra_bw=2 * 50e9,
    intra_alpha_s=1e-6,
    inter_bw=6.25e9,
    inter_alpha_s=25e-6,
    host_dma_bw=32e9,
    host_dma_alpha_s=10e-6,
)

# NVIDIA H100 80GB HBM3, SXM5, 700 W.  Rates are nominal datasheet figures;
# the alphas are nominal and unmeasured.
H100 = HardwareProfile(
    name="h100_sxm",
    # datasheet, nominal: 989 TFLOP/s dense bf16 on the tensor cores
    peak_flops_bf16=989e12,
    # datasheet, nominal: HBM3 at 3.35 TB/s
    hbm_bandwidth=3.35e12,
    # datasheet, nominal: 80 GB of HBM3, in decimal bytes (74.5 GiB).  The
    # card's total_memory is 85,017,493,504 B (79.18 GiB, less than 80
    # GiB), so a plan that fits 80e9 B fits the card; 80 GiB would pass
    # plans the card cannot hold
    hbm_bytes=80e9,
    # datasheet, nominal: NVLink 4, 900 GB/s bidirectional = 450 GB/s per
    # direction per GPU, for every axis inside the 8-GPU node
    intra_bw=450e9,
    intra_alpha_s=10e-6,        # nominal, unmeasured
    # datasheet, nominal: one NDR InfiniBand NIC per GPU, 400 Gb/s =
    # 50 GB/s per direction, on the 'pod' axis between nodes
    inter_bw=50e9,
    inter_alpha_s=25e-6,        # nominal, unmeasured
    # datasheet, nominal: PCIe Gen5 x16, 64 GB/s per direction
    host_dma_bw=64e9,
    host_dma_alpha_s=10e-6,     # nominal, unmeasured
)

_ACTIVE = [H100]


def active() -> HardwareProfile:
    """The profile the planners price with now."""
    return _ACTIVE[-1]


@contextlib.contextmanager
def use_profile(profile: HardwareProfile):
    """Price with `profile` inside the ``with`` block."""
    _ACTIVE.append(profile)
    try:
        yield profile
    finally:
        _ACTIVE.pop()


@dataclasses.dataclass(frozen=True)
class AxisBandwidth:
    """Effective collective bandwidth of one mesh axis for one device."""

    bytes_per_s: float
    alpha_s: float


# Measured per-axis collective bandwidth (a calibration installs it).
# Empty = the active profile's constants stand.
_MEASURED_AXIS_BW: dict[str, AxisBandwidth] = {}


def set_measured_axis_bandwidth(axis_name: str,
                                bw: AxisBandwidth | None
                                ) -> AxisBandwidth | None:
    """Install (or clear, with None) a measured bandwidth for one mesh
    axis; returns the previous override so callers can restore it."""
    prev = _MEASURED_AXIS_BW.get(axis_name)
    if bw is None:
        _MEASURED_AXIS_BW.pop(axis_name, None)
    else:
        _MEASURED_AXIS_BW[axis_name] = bw
    return prev


def measured_key() -> tuple:
    """Hashable view of the installed axis overrides (plan cache key)."""
    return tuple(sorted(_MEASURED_AXIS_BW.items()))


def axis_bandwidth(axis_name: str) -> AxisBandwidth:
    """A measured override wins; otherwise 'pod' is the between-nodes axis
    and every other axis rides the in-node interconnect."""
    meas = _MEASURED_AXIS_BW.get(axis_name)
    if meas is not None:
        return meas
    p = active()
    if axis_name == "pod":
        return AxisBandwidth(bytes_per_s=p.inter_bw, alpha_s=p.inter_alpha_s)
    return AxisBandwidth(bytes_per_s=p.intra_bw, alpha_s=p.intra_alpha_s)


def ring_hop_time_s(nbytes: float, axis_name: str = "data") -> float:
    """One neighbour hop of a ring exchange on one axis: alpha +
    payload / bandwidth of that axis."""
    bw = axis_bandwidth(axis_name)
    return bw.alpha_s + nbytes / bw.bytes_per_s


def collective_time_s(nbytes: float, axis_sizes: dict[str, int],
                      axes: tuple[str, ...]) -> float:
    """alpha + beta*n model for an all-gather / reduce-scatter over `axes`.

    `nbytes` is the full (gathered) payload.  A ring over an axis of size k
    moves (k-1)/k of it through each device's links; a collective over
    several axes is priced as sequential per-axis phases."""
    t = 0.0
    for ax in axes:
        k = axis_sizes[ax]
        if k <= 1:
            continue
        bw = axis_bandwidth(ax)
        t += bw.alpha_s + (nbytes * (k - 1) / k) / bw.bytes_per_s
    return t


def compute_time_s(flops: float, bytes_accessed: float) -> float:
    """Analytic kernel-time estimate: max of compute and memory roofline."""
    p = active()
    return max(flops / p.peak_flops_bf16, bytes_accessed / p.hbm_bandwidth)
