"""Reading a ``torch.profiler`` trace of the window: kernel intervals, the
busy union, lost records, the costliest device operations and the host's
work in the device's idle gaps.

The handling of lost records is the one the port's smoke run settled on:
a big profile can drop some device records, so each of the program's
launch counters is set beside the records of its kernels, and a trace
that lost any is taken again.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
from typing import Callable

# The port's kernels by the name the trace gives them (first match wins),
# and the launch counter of ``repro_torch.kernels.ops.launch_counts`` each
# is counted under.
PORT_KERNELS = (("block_scatter_kernel", "block_scatter"), ("margins_kernel", "sparse_margin"),
                ("coef_kernel", "logistic_grad"), ("range_kernel", "prox_update"),
                ("entries_kernel<(anonymous namespace)::ProbaUpdate", "lazy_proba_update"),
                ("entries_kernel", "lazy_touch_update"), ("lazy_catchup_kernel", "lazy_catchup"),
                ("lazy_flush_kernel", "lazy_flush"))
NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10  # entries of each breakdown list
HOST_SCAN = 256  # host events looked back over for one idle gap


@dataclasses.dataclass
class Trace:
    """One traced call: kernels and host events as (name, start_s, end_s),
    sorted by start, in the trace's clock; the call's wall on the host."""

    kernels: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]]
    wall_s: float

    @property
    def kernel_s(self) -> float:
        return sum(e - s for _, s, e in self.kernels)

    def busy_s(self) -> float:
        """Length of the union of the kernel intervals."""
        total, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.kernels:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def gaps(self) -> list[tuple[float, float]]:
        out, cur_e = [], None
        for _, s, e in self.kernels:
            if cur_e is not None and s > cur_e:
                out.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        return out


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameter list."""
    s = name.replace("(anonymous namespace)", "anon")
    prev = None
    while prev != s:
        prev, s = s, re.sub(r"<[^<>]*>", "", s)
    words = s.split("(")[0].split()
    return (words[-1].split("::")[-1] if words else "") or name


def counter_of(name: str) -> str | None:
    return next((c for key, c in PORT_KERNELS if key in name), None)


def lost_records(kernels, launches: dict[str, int]) -> int:
    """Launches of the program's counted kernels that left no record."""
    kept: dict[str, int] = {}
    for name, _, _ in kernels:
        c = counter_of(name)
        if c is not None:
            kept[c] = kept.get(c, 0) + 1
    return sum(max(n - kept.get(c, 0), 0) for c, n in launches.items()
               if any(c == pc for _, pc in PORT_KERNELS))


def _events(prof) -> tuple[list, list]:
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    kernels, host = [], []
    for ev in results.events():
        name = ev.name()
        start = (ev.start_ns() - base) * 1e-9
        end = start + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            # A range such as "nccl:all_reduce" annotates the device timeline
            # over the kernel it names; it is no kernel of its own.
            annotation = getattr(ev, "is_user_annotation", lambda: False)()
            if not name.startswith(NOT_KERNELS + ("nccl:",)) and not annotation:
                kernels.append((name, start, end))
        else:
            host.append((name, start, end))
    kernels.sort(key=lambda k: k[1])
    host.sort(key=lambda k: k[1])
    return kernels, host


def traced(fn: Callable, sync: Callable, *, host: bool = True):
    """``fn()`` under the profiler (the device, and with ``host`` the host's
    operators and runtime calls): its result and its :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    kernels, host_events = _events(prof)
    return out, Trace(kernels=kernels, host=host_events, wall_s=wall)


def device_ops(trace: Trace) -> list[list]:
    """The device operations that took most time: [name, seconds]."""
    by: dict[str, float] = {}
    for name, s, e in trace.kernels:
        key = short_name(name)
        by[key] = by.get(key, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(trace: Trace) -> list[list]:
    """The device's idle time by what the host was doing through it: each gap
    between kernels goes to the host event that covers most of it (the
    innermost on a tie), or to "python" where no recorded event covers
    half of it.  [name, seconds], the largest sums first."""
    starts = [h[1] for h in trace.host]
    by: dict[str, float] = {}
    for g0, g1 in trace.gaps():
        hi = bisect.bisect_left(starts, g1)
        best, best_cover = None, 0.0
        for name, s, e in trace.host[max(0, hi - HOST_SCAN):hi]:
            cover = min(e, g1) - max(s, g0)
            if cover > best_cover or (cover == best_cover and best is not None
                                      and e - s < best[1]):
                best, best_cover = (name, e - s), cover
        key = best[0] if best is not None and best_cover >= 0.5 * (g1 - g0) else "python"
        by[key] = by.get(key, 0.0) + (g1 - g0)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
