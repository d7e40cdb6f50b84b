"""Reading the program's spans out of a traced window.

The port records its layers as profiler ranges named ``rt/*`` (``rt/solve``,
``rt/outer``, ``rt/epoch``, ``rt/snapshot``, ``rt/evaluate``, ``rt/draw``,
``rt/step``, ``rt/flush``, ...) while a profiler records, so they arrive
among a :class:`bench.trace.Trace`'s host events, on the kernels' clock.  A
program without them yields no span, and the readers built on this module
then find nothing to read.
"""

from __future__ import annotations

import bisect

LAUNCH = "LaunchKernel"  # in the name of each host call that launches a kernel


def named(trace, name: str) -> list[tuple[float, float]]:
    """The (start, end) of each host event called ``name``, by start."""
    return [(s, e) for n, s, e in trace.host if n == name]


def union(intervals) -> list[tuple[float, float]]:
    """The intervals merged where they overlap or touch, by start."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """Length of the intersection of the unions of ``a`` and ``b``."""
    a, b = union(a), union(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def is_wait(name: str) -> bool:
    """A host event in which the host waits on the device: a full launch
    queue (``Command Buffer Full``, its words joined by ``_`` in some
    exports), or a synchronisation call of the runtime."""
    return name.replace(" ", "_") == "Command_Buffer_Full" or (
        name.startswith("cuda") and name.endswith("Synchronize"))


def launches(trace) -> list[float]:
    """The start of each host call that launched a kernel, in time order; a
    call inside another (a driver call under a runtime call) is the same
    launch and is left out."""
    out, end = [], None
    for name, s, e in trace.host:
        if LAUNCH in name and (end is None or s >= end):
            out.append(s)
            end = e
    return out


def within(spans: list[tuple[float, float]], t: float) -> bool:
    """Whether ``t`` lies in one of ``spans`` (disjoint, by start)."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def step_idle_s(trace) -> float | None:
    """Seconds of the device's idle gaps that fall inside ``rt/step`` spans;
    None without kernels or without steps."""
    steps = named(trace, "rt/step")
    if not trace.kernels or not steps:
        return None
    return overlap(trace.gaps(), steps)
