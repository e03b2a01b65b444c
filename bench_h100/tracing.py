"""From a torch.profiler trace to the device's busy time and the traced
run's breakdown.

Device activity is every event the profiler records on the card
(kernels, copies, sets), without the device-side copies of the host's
`record_function` labels, which span whole batches, idle time and all.
Busy time is the length of their union.  The idle gaps are the holes in
that union between its first and its last event, each named by what the
host was doing at its middle: the innermost host event open then (a
`record_function` label of the harness, an aten op, a CUDA runtime
call), or "host" where none was.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from torch.autograd import DeviceType

__all__ = ["TOP", "reduce"]

TOP = 10                    # entries of each breakdown list


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, starts, t):
    """The latest-opened host event still open at t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 512), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "host"


def reduce(events) -> dict:
    """events: `prof.events()` of one stretch.  -> {"busy_s",
    "device_ops": [[name, s]], "idle_gaps": [[name, s]]}, times in
    seconds (the profiler's are microseconds)."""
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append((s, t, e.name))
        elif e.device_type == DeviceType.CPU and not e.is_async:
            host.append((s, t, e.name))
    by_op = defaultdict(float)
    for s, t, name in dev:
        by_op[name] += (t - s) * 1e-6
    busy = _merge((s, t) for s, t, _ in dev)
    host.sort()
    starts = [h[0] for h in host]
    by_gap = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        by_gap[_innermost(host, starts, (end + nxt) / 2)] += (nxt - end) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return {"busy_s": sum(e - s for s, e in busy) * 1e-6,
            "device_ops": top(by_op), "idle_gaps": top(by_gap)}
