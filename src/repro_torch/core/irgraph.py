"""Pseudo IR nodes: the unit the auto-wrapper reasons about (port of
`repro.core.irgraph`).

TorchInductor hands the paper real IR nodes with module provenance; the
port, like the reference, synthesizes the equivalent before the step runs:
one `CommNode` per parameter (its all-gather + matching reduce-scatter)
annotated with the compute that consumes it.  Models supply the
per-parameter FLOP / byte estimates via `BlockStats` (their `block_stats()`
method); `core/autowrap.py` runs the paper's greedy Algorithm 1 and the
exposure-minimizing DP over this list.  Times come from the analytic model
of the active `core/hw.py` profile.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hw
from repro_torch.core.dist import DistConfig, precision_codecs
from repro_torch.core.meta import ParamMeta, named_leaves
from repro_torch.kernels.quant.ref import QCHUNK, SCALE_BYTES


def wire_bytes(n_elems: int, itemsize: int, codec: str | None = None) -> int:
    """The payload one length-n buffer occupies on the wire.  Uncompressed
    (codec=None): n * itemsize.  Quantized (fp8/int8): one byte per element
    plus an f32 scale per QCHUNK-element group — n + 4*ceil(n/128)."""
    if codec is None:
        return n_elems * itemsize
    return n_elems + SCALE_BYTES * (-(-n_elems // QCHUNK))


@dataclasses.dataclass(frozen=True)
class CommNode:
    """One parameter's collective + the compute it feeds (paper Table 1)."""

    name: str
    ag_bytes: int          # gathered payload (param_dtype, uncompressed)
    rs_bytes: int          # grad reduce-scatter payload (reduce dtype)
    comp_flops: float      # T_ci numerator: FLOPs of the consuming compute
    comp_bytes: float      # bytes accessed by the consuming compute
    mem_bytes: float       # M_ci: peak bytes to hold param + activations
    n_elems: int = 0       # padded element count (0 on hand-built nodes)

    def ag_wire(self, precision: str = "bf16") -> int:
        """All-gather wire bytes under a resolved comm precision."""
        codec = precision_codecs(precision)[0]
        if codec is None or not self.n_elems:
            return self.ag_bytes
        return wire_bytes(self.n_elems, 0, codec)

    def rs_wire(self, precision: str = "bf16") -> int:
        codec = precision_codecs(precision)[1]
        if codec is None or not self.n_elems:
            return self.rs_bytes
        return wire_bytes(self.n_elems, 0, codec)

    def t_comp(self) -> float:
        return hw.compute_time_s(self.comp_flops, self.comp_bytes)

    def act_out_bytes(self) -> float:
        """Estimated bytes of the activation(s) the consuming op produces:
        its traffic less the param read is the activation in + out, half
        of it the output."""
        return max(0.0, self.comp_bytes - self.ag_bytes) / 2.0


@dataclasses.dataclass(frozen=True)
class BlockStats:
    """Per-block workload: {param name: (flops, bytes_accessed)} for the op
    consuming each param, plus the activation footprint.

    ``source`` records where the numbers came from (``"analytic"``: the
    models' `block_stats()` roofline model).  ``seg_act_bytes`` holds
    measured per-segment activation footprints when a harvest supplied
    them; the memory simulator prefers these (None = derive analytically).
    """

    param_flops: dict[str, float]
    param_bytes: dict[str, float]
    act_bytes: float = 0.0
    source: str = "analytic"
    seg_act_bytes: dict[str, float] | None = None

    def cache_key(self) -> tuple:
        """Hashable identity for plan memoization (dict fields break the
        generated __hash__)."""
        return (self.source, self.act_bytes,
                tuple(sorted(self.param_flops.items())),
                tuple(sorted(self.param_bytes.items())),
                tuple(sorted(self.seg_act_bytes.items()))
                if self.seg_act_bytes else None)


def build_nodes(metas_tree, cfg: DistConfig,
                stats: BlockStats | None) -> list[CommNode]:
    """One CommNode per parameter, in declaration (flatten) order."""
    p_item = cfg.param_dtype.itemsize
    r_item = (torch.bfloat16 if cfg.grad_compression
              else cfg.reduce_dtype).itemsize
    nodes = []
    for name, m in named_leaves(metas_tree):
        assert isinstance(m, ParamMeta)
        n = m.padded_len(cfg)
        flops = stats.param_flops.get(name, 2.0 * n) if stats else 2.0 * n
        bts = stats.param_bytes.get(name, 3.0 * n * p_item) if stats \
            else 3.0 * n * p_item
        nodes.append(CommNode(
            name=name,
            ag_bytes=wire_bytes(n, p_item),
            rs_bytes=wire_bytes(n, r_item),
            comp_flops=flops,
            comp_bytes=bts,
            mem_bytes=n * p_item + (stats.act_bytes if stats else 0.0),
            n_elems=n,
        ))
    return nodes


def ag_time(nodes: list[CommNode], cfg: DistConfig,
            precision: str = "bf16") -> float:
    """alpha + beta*n for ONE bucketed all-gather of these nodes, priced at
    the bucket's resolved wire precision."""
    return hw.collective_time_s(sum(n.ag_wire(precision) for n in nodes),
                                cfg.axis_sizes, cfg.fsdp_axes)


def rs_time(nodes: list[CommNode], cfg: DistConfig,
            precision: str = "bf16") -> float:
    return hw.collective_time_s(sum(n.rs_wire(precision) for n in nodes),
                                cfg.axis_sizes, cfg.fsdp_axes)


# Measured codec throughput (bytes of full-precision input per second) per
# wire codec; a codec absent from the dict is priced by the analytic prior.
# fp8 and int8 have identical wire bytes, so a measured rate difference is
# the only thing that separates them in the planner lattice.
_MEASURED_QUANT_RATE: dict[str, float] = {}


def set_measured_quant_rate(rate: float | None,
                            codec: str = "fp8") -> float | None:
    """Install (or clear, with None) the measured quant rate for one
    codec; returns the previous value so callers can restore it."""
    prev = _MEASURED_QUANT_RATE.get(codec)
    if rate is None:
        _MEASURED_QUANT_RATE.pop(codec, None)
    else:
        _MEASURED_QUANT_RATE[codec] = rate
    return prev


def measured_key() -> tuple:
    """Hashable view of the installed codec rates (plan cache key)."""
    return tuple(sorted(_MEASURED_QUANT_RATE.items()))


def quant_codec_rate(codec: str = "fp8") -> float:
    """Bytes of full-precision buffer one quantize round-trip of `codec`
    processes per second: the measured rate when one was installed, else
    the analytic prior (2 HBM passes per endpoint = HBM bandwidth / 2)."""
    meas = _MEASURED_QUANT_RATE.get(codec)
    return meas if meas is not None else hw.active().hbm_bandwidth / 2.0


def quant_overhead_s(nodes: list[CommNode], precision: str = "bf16") -> float:
    """Encode + decode cost of quantizing a bucket, per quantized endpoint,
    each at its codec's `quant_codec_rate`.  Zero for bf16, so the
    planner's tie-break toward bf16 falls out of the exposure objective."""
    ag_codec, rs_codec = precision_codecs(precision)
    t = 0.0
    if ag_codec is not None:
        t += sum(n.ag_bytes for n in nodes) / quant_codec_rate(ag_codec)
    if rs_codec is not None:
        t += sum(n.rs_bytes for n in nodes) / quant_codec_rate(rs_codec)
    return t


def comp_time(nodes: list[CommNode]) -> float:
    return sum(n.t_comp() for n in nodes)
