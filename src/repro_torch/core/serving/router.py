"""Multi-replica admission router: cost-model-driven routing + latency
projection under a synthetic traffic trace.

Each replica is a ServePlan; its service rates come straight from the
roofline numbers frozen into the plan (tokens/sec prefill, per-step
decode).  The router projects every candidate replica's finish time for
an incoming request from its current slot backlog and routes to the
argmin — the serving analogue of the training planners' cost-model
argmin, and the same numbers the p50/p99 projection integrates.

Everything here is host math (an event simulation over slot free-times),
deterministic by construction: the trace generator uses its own seeded
PRNG, never wall clock."""

from __future__ import annotations

import dataclasses
import heapq
import math
import random

from repro_torch.core.serving.scheduler import Request, ServePlan, _pct


def synthetic_trace(n: int, *, seed: int = 0, mean_interarrival_s: float,
                    prompt_lens=(64, 128, 256), gen_lens=(16, 64, 256),
                    vocab: int = 256) -> list[Request]:
    """Poisson arrivals, mixed prompt/gen lengths — the heavy-traffic mix
    (mostly short, a long tail) serving schedulers are judged on."""
    rng = random.Random(seed)
    reqs, t = [], 0.0
    for i in range(n):
        t += rng.expovariate(1.0 / mean_interarrival_s)
        pl = rng.choice(prompt_lens)
        reqs.append(Request(
            rid=i,
            prompt=tuple(rng.randrange(3, vocab) for _ in range(pl)),
            max_new=rng.choice(gen_lens), arrival=t))
    return reqs


@dataclasses.dataclass
class _Replica:
    plan: ServePlan
    slots: list          # heap of slot free-times
    assigned: int = 0
    busy_s: float = 0.0
    # measured-over-modeled decode-time ratio: the roofline is the
    # prior (1.0), observed decode steps move it (the posterior the
    # projections integrate)
    decode_scale: float = 1.0

    def projected_start(self, arrival: float) -> float:
        return max(arrival, self.slots[0])

    def service_time(self, req: Request) -> float:
        p = self.plan
        return (p.prefill_time(len(req.prompt))
                + req.max_new * self.decode_scale * p.decode_step_time(
                    p.max_batch, (len(req.prompt) + req.max_new / 2)))


class Router:
    """Admission control + routing over N replicas.

    `admit_slo_s`: a request whose best projected queue wait exceeds the
    SLO is rejected at the door (load shedding) instead of blowing up
    the tail for everyone already admitted.

    Latency projections start from each replica's roofline (the prior)
    and are corrected by measured decode-step feedback when an executor
    reports it (`observe_decode` / `feed_from_batcher`) — with no
    feedback the behavior is bit-identical to the pure-model router."""

    def __init__(self, plans: list[ServePlan],
                 admit_slo_s: float | None = None, registry=None):
        self.replicas = [
            _Replica(plan=p, slots=[0.0] * p.max_batch) for p in plans]
        self.admit_slo_s = admit_slo_s
        self.registry = registry
        self.rejected: list[Request] = []

    def observe_decode(self, idx: int, measured_step_s: float,
                       modeled_step_s: float | None = None,
                       alpha: float = 0.2) -> float:
        """Fold one measured decode step into replica `idx`'s posterior.
        `modeled_step_s` defaults to the replica's own full-batch roofline
        step; returns the updated decode_scale."""
        rep = self.replicas[idx]
        if modeled_step_s is None:
            modeled_step_s = rep.plan.decode_step_s
        ratio = measured_step_s / modeled_step_s if modeled_step_s > 0 \
            else 1.0
        rep.decode_scale = alpha * ratio + (1.0 - alpha) * rep.decode_scale
        if self.registry is not None:
            self.registry.gauge(f"router/replica{idx}/decode_scale").set(
                rep.decode_scale)
        return rep.decode_scale

    def feed_from_batcher(self, idx: int, batcher,
                          alpha: float = 0.2) -> float:
        """Pull the scale-free decode_ratio EWMA a ContinuousBatcher
        accumulated (scheduler.decode_ratio) into replica `idx`."""
        rep = self.replicas[idx]
        if getattr(batcher, "decode_ratio", None) is not None:
            rep.decode_scale = (alpha * batcher.decode_ratio
                                + (1.0 - alpha) * rep.decode_scale)
            if self.registry is not None:
                self.registry.gauge(
                    f"router/replica{idx}/decode_scale").set(
                        rep.decode_scale)
        return rep.decode_scale

    def route(self, req: Request) -> tuple[int, float] | None:
        """Pick the replica with the earliest projected start; returns
        (replica index, projected completion latency), or None when
        admission control rejects."""
        best, best_t = None, math.inf
        for i, rep in enumerate(self.replicas):
            t = rep.projected_start(req.arrival)
            if t < best_t:
                best, best_t = i, t
        if (self.admit_slo_s is not None
                and best_t - req.arrival > self.admit_slo_s):
            self.rejected.append(req)
            if self.registry is not None:
                self.registry.counter("router/rejected").inc()
            return None
        rep = self.replicas[best]
        start = max(heapq.heappop(rep.slots), req.arrival)
        svc = rep.service_time(req)
        heapq.heappush(rep.slots, start + svc)
        rep.assigned += 1
        rep.busy_s += svc
        lat = start + svc - req.arrival
        if self.registry is not None:
            self.registry.histogram("router/projected_latency_s").observe(
                lat)
        return best, lat


def simulate_trace(plans: list[ServePlan], trace: list[Request],
                   admit_slo_s: float | None = None) -> dict:
    """Route a whole trace, project per-request latency, aggregate."""
    router = Router(plans, admit_slo_s=admit_slo_s)
    lats = []
    for req in sorted(trace, key=lambda r: r.arrival):
        routed = router.route(req)
        if routed is not None:
            lats.append(routed[1])
    horizon = max((max(r.slots) for r in router.replicas), default=0.0)
    total_tokens = sum(r.max_new for r in trace) - \
        sum(r.max_new for r in router.rejected)
    return dict(
        requests=len(trace), admitted=len(lats),
        rejected=len(router.rejected),
        p50_s=_pct(lats, 50), p99_s=_pct(lats, 99),
        tok_s=total_tokens / horizon if horizon else 0.0,
        per_replica=[
            dict(assigned=r.assigned,
                 utilization=r.busy_s / horizon if horizon else 0.0)
            for r in router.replicas])
