"""Typed per-step metrics registry: counters / gauges / histograms with
EWMA aggregation and a JSONL sink (a copy of `repro.core.obs.metrics`,
which is plain Python; the port imports nothing of the reference).

One registry instance is threaded through the runtime surfaces that
report numbers: `train/trainer.py` (step time, tokens/s, grad norm, loss,
wire bytes by precision, replans) and its modeled-vs-measured peak.  The
registry is the ONE audited path for modeled-vs-measured peak reporting
(`record_peak`), so every site that sets the memory plan beside a
measured peak shares the arithmetic and the format.

Design constraints:
  * near-zero overhead per record — a metric update is one attribute
    write plus one multiply (the EWMA);
  * deterministic snapshots — insertion-ordered dicts, no wall clock
    anywhere in this module (timestamps are the caller's business);
  * a metric name is bound to ONE type — re-registering `train/steps` as
    a gauge after it was a counter is a pointed TypeError, not a silent
    shadow.
"""

from __future__ import annotations

import json
import math
import os


class Counter:
    """Monotonic accumulator (events, bytes, tokens)."""

    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def snapshot(self) -> dict:
        return {"kind": "counter", "value": self.value}


class Gauge:
    """Last-value metric with a built-in EWMA (the smoothed series the
    drift monitor and the router posterior consume)."""

    __slots__ = ("name", "alpha", "value", "ewma", "n")
    kind = "gauge"

    def __init__(self, name: str, alpha: float = 0.2):
        self.name = name
        self.alpha = alpha
        self.value: float | None = None
        self.ewma: float | None = None
        self.n = 0

    def set(self, v: float) -> None:
        self.value = v
        self.ewma = v if self.ewma is None \
            else self.alpha * v + (1.0 - self.alpha) * self.ewma
        self.n += 1

    def snapshot(self) -> dict:
        return {"kind": "gauge", "value": self.value, "ewma": self.ewma,
                "n": self.n}


class Histogram:
    """Bounded-window distribution: count/sum over the full stream,
    percentiles over the last `window` observations (enough for p50/p99
    of a serving trace without unbounded growth on a long run)."""

    __slots__ = ("name", "window", "count", "sum", "min", "max", "_ring",
                 "_pos")
    kind = "histogram"

    def __init__(self, name: str, window: int = 1024):
        self.name = name
        self.window = window
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._ring: list[float] = []
        self._pos = 0

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._ring) < self.window:
            self._ring.append(v)
        else:
            self._ring[self._pos] = v
            self._pos = (self._pos + 1) % self.window

    def percentile(self, q: float) -> float:
        if not self._ring:
            return 0.0
        ys = sorted(self._ring)
        i = min(len(ys) - 1, int(round((q / 100.0) * (len(ys) - 1))))
        return float(ys[i])

    def snapshot(self) -> dict:
        return {"kind": "histogram", "count": self.count, "sum": self.sum,
                "mean": self.sum / self.count if self.count else 0.0,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class MetricsRegistry:
    """Get-or-create registry of typed metrics + the JSONL sink.

    Naming convention is path-like (`train/step_time_s`,
    `serving/queue_depth`, `router/rejected`) so one registry can carry
    every subsystem without collisions.
    """

    def __init__(self, ewma_alpha: float = 0.2):
        self.ewma_alpha = ewma_alpha
        self._metrics: dict[str, object] = {}

    # ------------------------------------------------------------ typed --
    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {m.kind}, not a {cls.kind}; one "
                "name binds one type (rename one of the call sites)")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, alpha=self.ewma_alpha)

    def histogram(self, name: str, window: int = 1024) -> Histogram:
        return self._get(name, Histogram, window=window)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return list(self._metrics)

    # --------------------------------------------------------- snapshot --
    def snapshot(self) -> dict:
        """{name: metric snapshot} in registration order (deterministic
        for a deterministic call sequence)."""
        return {k: m.snapshot() for k, m in self._metrics.items()}

    def dump_jsonl(self, path: str, step: int | None = None,
                   **extra) -> None:
        """Append one JSON object (step + full snapshot) to `path` — the
        sink `Trainer` writes at every log interval when
        `TrainerConfig.metrics_jsonl` is set."""
        row = {"step": step, **extra, "metrics": self.snapshot()}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(row, sort_keys=True) + "\n")

    # -------------------------------------------- modeled vs measured ----
    def record_peak(self, scope: str, modeled_bytes: float,
                    measured_bytes: float, budget_bytes: float | None = None,
                    note: str = "") -> str:
        """THE modeled-vs-measured peak-memory path: records both sides
        (plus their ratio) as gauges under `scope/` and returns the one
        canonical log line.  `trainer.memory_report()` routes through here
        (the reference's dryrun `[mem]` print does too), so the sites can
        never diverge in arithmetic or format."""
        gib = 1.0 / 2**30
        ratio = modeled_bytes / max(1.0, measured_bytes)
        self.gauge(f"{scope}/modeled_peak_bytes").set(float(modeled_bytes))
        self.gauge(f"{scope}/measured_peak_bytes").set(float(measured_bytes))
        self.gauge(f"{scope}/modeled_over_measured").set(ratio)
        line = (f"{scope}: modeled peak {modeled_bytes * gib:.2f} GiB vs "
                f"measured {measured_bytes * gib:.2f} GiB "
                f"(modeled/measured {ratio:.2f}")
        if budget_bytes is not None:
            line += f", budget {budget_bytes * gib:.0f} GiB"
        if note:
            line += f", {note}"
        return line + ")"


_DEFAULT: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    """Process-wide registry for call sites with no owner to thread one
    through."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT
