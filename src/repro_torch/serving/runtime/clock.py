"""Deterministic time seam for the serving schedulers (DESIGN.md §12).

Scheduler code is exactly where wall-clock coupling turns tests into
sleep festivals: a deadline flush is "wait 2 ms", a drain is "join and
hope".  Both schedulers (`MicroBatcher`, `SlotLoop`) therefore never
call `time.monotonic()` or `Condition.wait(timeout)` directly — they go
through an injected `Clock`:

  * `SystemClock` (production default) — `time.monotonic()` + real
    `Condition.wait` timeouts; zero behavioural change.
  * `VirtualClock` (tests) — time advances only when the test calls
    `advance(dt)`; a timed wait parks on the condition until a notify
    arrives or virtual time passes its deadline.  Tests drive the
    scheduler through its deadline logic deterministically, with no
    real sleeping and no timing races.

The contract mirrors `threading.Condition.wait`: `wait(cv, timeout)`
may return spuriously (callers re-check their predicate), must be
called with `cv`'s lock held, and a `timeout=None` wait returns only on
notify.  `VirtualClock` keeps a small *real* safety timeout underneath
so a test that forgets to `advance()` fails loudly instead of hanging
the suite.
"""

from __future__ import annotations

import threading
import time

__all__ = ["Clock", "SystemClock", "VirtualClock"]


class Clock:
    """Scheduler time source: `now()` seconds + condition-wait seam."""

    def now(self) -> float:
        raise NotImplementedError

    def wait(self, cv: threading.Condition, timeout: float | None):
        """Park on `cv` (lock held by caller) until notified or until
        `timeout` seconds of *this clock's* time have passed.  May
        return spuriously, like `Condition.wait`."""
        raise NotImplementedError


class SystemClock(Clock):
    """Wall-clock time — the production default."""

    def now(self) -> float:
        return time.monotonic()

    def wait(self, cv: threading.Condition, timeout: float | None):
        cv.wait(timeout=timeout)


class VirtualClock(Clock):
    """Manually advanced time for deterministic scheduler tests.

    `advance(dt)` moves time forward and wakes every timed waiter whose
    deadline has passed; untimed waiters wake only on their condition's
    own notify (exactly the semantics the schedulers assume).  A
    `safety_s` *real* timeout underneath every park keeps a buggy test
    from deadlocking the whole suite — spurious returns are legal, so
    this never changes scheduler behaviour.
    """

    def __init__(self, start: float = 0.0, safety_s: float = 10.0):
        self._t = float(start)
        self.safety_s = float(safety_s)
        self._lock = threading.Lock()
        self._changed = threading.Condition(self._lock)
        self._waiters: list[tuple[threading.Condition, float]] = []

    def now(self) -> float:
        with self._lock:
            return self._t

    def wait(self, cv: threading.Condition, timeout: float | None):
        if timeout is None:
            cv.wait(timeout=self.safety_s)
            return
        with self._lock:
            # registered before cv.wait releases cv's lock: an
            # advance() racing this wait either sees the entry and
            # notifies, or has already moved time — the scheduler
            # re-checks `now()` against its deadline on return anyway
            entry = (cv, self._t + float(timeout))
            self._waiters.append(entry)
            self._changed.notify_all()
        try:
            cv.wait(timeout=self.safety_s)
        finally:
            with self._lock:
                if entry in self._waiters:
                    self._waiters.remove(entry)
                self._changed.notify_all()

    def advance(self, dt: float):
        """Move virtual time forward and wake expired timed waiters."""
        if dt < 0:
            raise ValueError(f"cannot advance time backwards ({dt})")
        with self._lock:
            self._t += float(dt)
            due = [cv for cv, deadline in self._waiters
                   if deadline <= self._t]
        for cv in due:
            with cv:
                cv.notify_all()

    def wait_for_waiters(self, n: int = 1, timeout: float = 10.0) -> int:
        """Block (real time) until >= n timed waiters are parked — the
        deterministic sync point for "the scheduler is now waiting on
        its deadline" before a test advances the clock."""
        with self._changed:
            ok = self._changed.wait_for(
                lambda: len(self._waiters) >= n, timeout=timeout)
            if not ok:
                raise TimeoutError(
                    f"{len(self._waiters)} timed waiter(s) after "
                    f"{timeout}s (wanted {n})")
            return len(self._waiters)
