"""Unified telemetry (port of `repro.core.obs`): plan-aligned trace
timelines (`trace`), the typed per-step metrics registry (`metrics`), the
modeled-vs-measured drift monitor (`drift`), and the profile -> calibrate
-> replan loop (`profile` + `calibrate`).

The observability counterpart of the plan-centric architecture: the
collective exposure model renders into ONE Chrome-trace timeline and ONE
registry; the drift monitor scores the residuals per subsystem, the step
profiler measures the executed schedule on the card, and calibration
feeds the measured rates back into the planners so a drifted plan can be
re-planned against reality.  The reference's pipeline and serving lanes
(`trace.pipeline_lanes`, `trace.serving_lanes`) raise until their modules
are ported and are not exported.
"""

from repro_torch.core.obs.calibrate import (calibrated_block_stats,
                                            calibrated_step_time,
                                            calibration, replan)
from repro_torch.core.obs.drift import (SUBSYSTEMS, DriftMonitor,
                                        modeled_step_time)
from repro_torch.core.obs.metrics import (Counter, Gauge, Histogram,
                                          MetricsRegistry, default_registry)
from repro_torch.core.obs.profile import MeasuredProfile, profile_step
from repro_torch.core.obs.trace import (PID_MEASURED, PID_MODELED,
                                        TID_COMM, TID_COMPUTE, TID_STRAGGLER,
                                        TraceBuilder, comm_windows,
                                        emit_comm_lanes, lane_spans,
                                        measured_overlay,
                                        nonoverlapped_comm_s,
                                        plan_comm_windows, plan_trace,
                                        ring_lanes)

__all__ = [
    "SUBSYSTEMS", "DriftMonitor", "modeled_step_time",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "MeasuredProfile", "profile_step",
    "calibrated_block_stats", "calibrated_step_time", "calibration",
    "replan",
    "PID_MEASURED", "PID_MODELED", "TID_COMM", "TID_COMPUTE",
    "TID_STRAGGLER", "TraceBuilder", "comm_windows", "emit_comm_lanes",
    "lane_spans", "measured_overlay", "nonoverlapped_comm_s",
    "plan_comm_windows", "plan_trace", "ring_lanes",
]
