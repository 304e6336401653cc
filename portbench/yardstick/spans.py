"""The program's spans in a ``Trace``: the arithmetic the span metrics
share.

A program span is a host operation whose name starts with ``nmpc.`` (the
port's ``utils.timing.span``: ``nmpc.step`` and its seven stages,
``nmpc.kernel.<key>``, ``nmpc.perception.*``, ``nmpc.scaleout.stats``).  A
blocking call is a host operation whose name contains ``Synchronize`` or
starts with ``cudaMemcpy``; a launch is one of ``LAUNCHES``.  Every interval
is clipped to the profiled window, and each sum is divided by the window's
units.  Each function returns None where there is no trace or the window
holds no ``nmpc.step``.
"""

from __future__ import annotations

import bisect

from . import stats

PREFIX = "nmpc."
STEP = "nmpc.step"
ROWS = ("nmpc.step.lin", "nmpc.step.rows", "nmpc.step.terminal")
QP = ("nmpc.step.condense", "nmpc.step.gram", "nmpc.step.qp", "nmpc.step.update")
KERNEL = "nmpc.kernel."
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"})
STAGES = ROWS + QP


def is_blocking(name: str) -> bool:
    return "Synchronize" in name or name.startswith("cudaMemcpy")


def merged(intervals) -> list:
    """Disjoint, sorted (start, end) pairs covering the same time as
    ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """Seconds covered by both unions of intervals ``a`` and ``b``."""
    a, b = merged(a), merged(b)
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


def within(intervals):
    """A test ``inside(t)``: whether time ``t`` lies in the union of
    ``intervals``."""
    m = merged(intervals)
    starts = [s for s, _ in m]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= m[i][1]

    return inside


def count_inside(points, intervals) -> int:
    """How many of ``points`` lie inside the union of ``intervals``."""
    return sum(map(within(intervals), points))


def host(trace, match) -> list:
    """(start, end) of the host operations whose name ``match`` accepts,
    clipped to the window."""
    return [(max(s, trace.start), min(e, trace.end)) for n, s, e in trace.host_ops
            if match(n) and e > trace.start and s < trace.end]


def steps(trace):
    """The window's ``nmpc.step`` intervals, or None where there are none
    (or no trace)."""
    if trace is None:
        return None
    return host(trace, lambda n: n == STEP) or None


def per_unit_ms(trace, seconds: float) -> float:
    return 1e3 * seconds / trace.units


def step_host_ms(trace):
    """Host ms inside ``nmpc.step`` per unit."""
    st = steps(trace)
    return None if st is None else per_unit_ms(trace, stats.union_length(st))


def stages_host_ms(trace, names):
    """Host ms inside the ``names`` stage spans, within ``nmpc.step``, per
    unit."""
    st = steps(trace)
    if st is None:
        return None
    return per_unit_ms(trace, overlap(host(trace, lambda n: n in names), st))


def step_wait_ms(trace):
    """Host ms in blocking calls inside ``nmpc.step`` per unit."""
    st = steps(trace)
    if st is None:
        return None
    return per_unit_ms(trace, overlap(host(trace, is_blocking), st))


def step_launches(trace):
    """Launches (kernels, copies, fills) issued inside ``nmpc.step`` per
    unit."""
    st = steps(trace)
    if st is None:
        return None
    return count_inside([s for s, _ in host(trace, lambda n: n in LAUNCHES)], st) / trace.units


def kernel_host_ms(trace):
    """Host ms inside the kernel wrappers' ``nmpc.kernel.*`` spans per unit."""
    if steps(trace) is None:
        return None
    return per_unit_ms(trace, stats.union_length(host(trace, lambda n: n.startswith(KERNEL))))


def idle_gaps(trace) -> list:
    """The device's idle stretches of the window, as ``Trace.top_idle_gaps``
    finds them."""
    return stats.gaps(trace._clipped(), trace.start, trace.end)


def idle_inside(gaps, intervals) -> float:
    """Seconds of the ``gaps`` whose midpoint lies inside ``intervals``."""
    inside = within(intervals)
    return sum(b - a for a, b in gaps if inside(0.5 * (a + b)))


def idle_in_step_ms(trace):
    """Device idle ms, per unit, in the gaps whose midpoint lies inside an
    ``nmpc.step``; None also where the trace has no device operation."""
    st = steps(trace)
    if st is None or not trace.device_ops:
        return None
    return per_unit_ms(trace, idle_inside(idle_gaps(trace), st))



def stage_table(trace) -> list:
    """Per span name (``nmpc.step``, its stages, each ``nmpc.kernel.*``):
    [name, host ms, launches, blocking calls, device idle ms], each per unit
    and counted inside that span's own intervals.  For the tables of
    PERF.md; None without a step."""
    if steps(trace) is None:
        return None
    names = sorted({n for n, _, _ in trace.host_ops if n.startswith(PREFIX)},
                   key=lambda n: (n != STEP, n not in STAGES,
                                  STAGES.index(n) if n in STAGES else 0, n))
    launches = [s for s, _ in host(trace, lambda n: n in LAUNCHES)]
    blocking = [s for s, _ in host(trace, is_blocking)]
    gaps = idle_gaps(trace) if trace.device_ops else []
    rows = []
    for name in names:
        iv = host(trace, lambda n: n == name)
        rows.append([name, per_unit_ms(trace, stats.union_length(iv)),
                     count_inside(launches, iv) / trace.units,
                     count_inside(blocking, iv) / trace.units,
                     per_unit_ms(trace, idle_inside(gaps, iv))])
    return rows
