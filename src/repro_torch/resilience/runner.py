"""Checkpoint-restart step runner + straggler watchdog on the Clock
seam (DESIGN.md §16), the counterpart of `repro.resilience.runner`
(host code, copied).

It runs on the injected `Clock` (DESIGN.md §12) — the same seam the
schedulers, telemetry, and trace spans run on, so retry backoff and
straggler deadlines are assertable on `VirtualClock` without real
sleeping.  `repro_torch.ft` is a deprecation shim re-exporting these
names.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

from ..serving.runtime.clock import Clock, SystemClock

__all__ = ["RetryPolicy", "ResilientRunner", "StragglerWatchdog",
           "sleep_on"]


def sleep_on(clock: Clock, seconds: float) -> None:
    """Sleep `seconds` of *clock* time: a condition-wait loop that
    re-checks the deadline on every (possibly spurious) wakeup.  Under
    `SystemClock` this is a plain timed sleep; under `VirtualClock` it
    parks as a timed waiter until the test advances past the deadline —
    the clock-seam replacement for `time.sleep` everywhere in the
    resilience layer."""
    if seconds <= 0:
        return
    cv = threading.Condition()
    deadline = clock.now() + float(seconds)
    with cv:
        while True:
            remaining = deadline - clock.now()
            if remaining <= 0:
                return
            clock.wait(cv, timeout=remaining)


@dataclasses.dataclass
class RetryPolicy:
    max_restarts: int = 3
    backoff_s: float = 0.0         # real deployments back off; tests don't


class ResilientRunner:
    """Wraps a step function with checkpoint-restart semantics:

        run step -> exception? -> restore latest checkpoint -> continue

    Failures are injected in tests via a hook; backoff between restarts
    runs on the injected clock."""

    def __init__(self, step_fn: Callable, save_fn: Callable,
                 restore_fn: Callable, policy: RetryPolicy = RetryPolicy(),
                 checkpoint_every: int = 10, clock: Clock | None = None):
        self.step_fn = step_fn
        self.save_fn = save_fn          # (step, state) -> None
        self.restore_fn = restore_fn    # () -> (step, state)
        self.policy = policy
        self.checkpoint_every = checkpoint_every
        self.clock = clock if clock is not None else SystemClock()
        self.restarts = 0
        self.failures_seen = 0

    def run(self, state, start_step: int, n_steps: int, get_batch):
        """Run n_steps; on failure restore the latest checkpoint and replay.
        get_batch(step) must be deterministic in step (resumable loader)."""
        step = start_step
        end = start_step + n_steps
        metrics = None
        while step < end:
            try:
                state, metrics = self.step_fn(state, get_batch(step))
                step += 1
                if step % self.checkpoint_every == 0:
                    self.save_fn(step, state)
            except Exception:
                self.failures_seen += 1
                self.restarts += 1
                if self.restarts > self.policy.max_restarts:
                    raise
                if self.policy.backoff_s:
                    sleep_on(self.clock, self.policy.backoff_s)
                step, state = self.restore_fn()
        return state, step, metrics


class StragglerWatchdog:
    """Deadline-based straggler mitigation for host-side work.

    Tracks a rolling median of durations on the injected clock;
    `run_sharded` dispatches a callable per shard and re-dispatches (to
    a fallback executor) any shard exceeding `factor` x median — the
    standard backup-task trick."""

    def __init__(self, factor: float = 3.0, window: int = 32,
                 min_deadline_s: float = 1e-3,
                 clock: Clock | None = None):
        self.factor = factor
        self.durations: list[float] = []
        self.window = window
        self.min_deadline_s = min_deadline_s
        self.clock = clock if clock is not None else SystemClock()
        self.redispatches = 0

    @property
    def deadline_s(self) -> float:
        if not self.durations:
            return float("inf")
        tail = sorted(self.durations[-self.window:])
        med = tail[len(tail) // 2]
        return max(self.factor * med, self.min_deadline_s)

    def observe(self, duration_s: float):
        self.durations.append(duration_s)

    def run_sharded(self, shard_fns, fallback_fn=None):
        """Execute each shard fn; any shard slower than the deadline is
        re-run via fallback_fn (e.g., on a spare host).  Sequential here —
        the scheduling logic, not the parallel substrate, is under test."""
        results = []
        for i, fn in enumerate(shard_fns):
            t0 = self.clock.now()
            out = fn()
            dt = self.clock.now() - t0
            if dt > self.deadline_s and fallback_fn is not None:
                self.redispatches += 1
                out = fallback_fn(i)
            else:
                self.observe(dt)
            results.append(out)
        return results
