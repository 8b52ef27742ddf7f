"""Fault-tolerance primitives: failure detection/injection, straggler
mitigation, restart policy (a copy of `repro.ft.failures`, which is plain
Python; the port imports nothing of the reference).

Hardware failures are *simulated* through the same interfaces a multi-host
deployment would use: the trainer consults a `FailureSource` each step (in
production: a heartbeat/barrier watchdog over the process group), and on
failure tears the step down and restarts from the last checkpoint —
bit-exact, as tests/test_torch_train.py asserts.

Straggler mitigation follows the standard production recipe: track a rolling
median of step wall-times; a step exceeding `threshold x median` is flagged
and counted, and after `escalate_after` consecutive flags the policy asks for
a restart (in production: cordon the slow host and rejoin the job elastically
— which our topology-independent checkpoints support directly).
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import time


class FailureSource:
    """Interface: returns True if the cluster lost a participant."""

    def check(self, step: int) -> bool:
        return False


@dataclasses.dataclass
class InjectedFailures(FailureSource):
    """Deterministic failure injection for tests/examples."""

    fail_at_steps: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> bool:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            return True
        return False


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0
    escalate_after: int = 3
    window: int = 32

    def __post_init__(self):
        self._times = collections.deque(maxlen=self.window)
        self._consecutive = 0
        self.flags = 0

    def observe(self, dt: float) -> str:
        """Returns 'ok' | 'straggler' | 'escalate'."""
        if len(self._times) >= 5:
            med = statistics.median(self._times)
            if dt > self.threshold * med:
                self.flags += 1
                self._consecutive += 1
                self._times.append(dt)
                if self._consecutive >= self.escalate_after:
                    self._consecutive = 0
                    return "escalate"
                return "straggler"
        self._consecutive = 0
        self._times.append(dt)
        return "ok"


class StepTimer:
    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.dt = time.monotonic() - self.t0
        return False
