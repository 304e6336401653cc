"""Statistics over a window's samples, computed the same way in every run."""

from __future__ import annotations

import math


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) of all values, linear between order
    statistics (numpy's default 'linear' method)."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("quantile of no values")
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if not seconds > 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals: overlaps count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float):
    """The idle stretches of [start, end] that no interval covers, as
    (start, end) pairs in time order."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]

