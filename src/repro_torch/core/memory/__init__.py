"""Memory subsystem (port of `repro.core.memory`): live-range peak
simulation + budgeted auto-SAC.

  simulator   walk the executed schedule, take the max over live bytes —
              the memory-side twin of autowrap's exposure walk
  planner     ``remat="auto:<GB>"`` -> per-segment policy vector (+ offload
              + joint bucket retightening) under an explicit HBM budget
  offload     the pinned host memory channel

Resolved once per (model, dcfg, shape) by `core/api.plan_parallel` into the
frozen `MemoryPlan` on the `ParallelPlan`.
"""

from repro_torch.core.memory.planner import (MemoryPlan, RECOMPUTE_W,
                                             auto_microbatches, plan_cost_s,
                                             plan_memory)
from repro_torch.core.memory.simulator import (BlockProfile, MemoryBreakdown,
                                               SegmentProfile, SimContext,
                                               build_block_profile,
                                               context_peaks,
                                               executed_segments,
                                               in_flight_microbatches,
                                               main_block_key, make_context,
                                               simulate_peak, storage_bytes)
from repro_torch.core.memory.offload import (host_offload_supported,
                                             to_device, to_host)

__all__ = [
    "BlockProfile", "MemoryBreakdown", "MemoryPlan", "RECOMPUTE_W",
    "SegmentProfile", "SimContext", "auto_microbatches",
    "build_block_profile", "context_peaks",
    "executed_segments", "host_offload_supported",
    "in_flight_microbatches", "main_block_key", "make_context",
    "plan_cost_s", "plan_memory", "simulate_peak", "storage_bytes",
    "to_device", "to_host",
]
