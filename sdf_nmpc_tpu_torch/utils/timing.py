"""Timing and profiling helpers.

Counterpart of sdf_nmpc_tpu/utils/timing.py: a stopwatch for host-side
stage timing, a ``torch.profiler`` trace context, and a throughput meter for
batched solves, under the JAX module's three names.  Where the JAX helpers
block on a device array's leaf, these end with ``torch.cuda.synchronize``
of the CUDA device a tensor leaf lives on: that waits for all work queued
on the card, not one result, which times the same span when the timed work
is the only work queued.  CPU tensors need no wait.

The card's own timers (``chip_smoke.py`` and the CLIs time with them):
``cuda_ms`` (CUDA events around repeated runs), ``profiled_kernel_ms``
(the profiler's kernel events by name), ``PartTimer`` (CUDA events around
named parts), ``peak_gib`` (peak device memory of a call) and ``synced_ms``
(wall ms between two synchronizes).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


def tensor_leaves(tree):
    """The tensors of a nested structure of dicts, lists, tuples and named
    tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tensor_leaves(item)]
    return []


def block_on_tree(tree, first_only: bool = False) -> None:
    """Wait for the CUDA devices the tensor leaves of ``tree`` live on (the
    first leaf's alone with ``first_only``); CPU leaves need no wait."""
    leaves = tensor_leaves(tree)
    if first_only:
        leaves = leaves[:1]
    for dev in dict.fromkeys(t.device for t in leaves if t.device.type == "cuda"):
        torch.cuda.synchronize(dev)


class Stopwatch:
    """Accumulating named stage timer (waits for the card if asked)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_on_tree(block_on)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {"total_s": t, "count": self.counts[name], "mean_ms": 1e3 * t / self.counts[name]}
            for name, t in self.totals.items()
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the body (CPU, and CUDA where a card is
    present), written under ``log_dir`` for TensorBoard's profiler plugin or
    ``chrome://tracing``; the profiler stops, and the trace is written, when
    the body raises too.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))) \
            as prof:
        yield prof


class ThroughputMeter:
    """solves/s + latency percentiles over repeated batched solves."""

    def __init__(self, batch: int):
        self.batch = batch
        self.times: list[float] = []

    @contextlib.contextmanager
    def step(self, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_on_tree(block_on, first_only=True)
        self.times.append(time.perf_counter() - t0)

    def stats(self) -> dict:
        t = np.asarray(self.times)
        med = float(np.median(t))
        return {
            "steps": len(t),
            "median_step_ms": 1e3 * med,
            "p99_step_ms": float(np.percentile(t, 99)) * 1e3,
            "solves_per_s": self.batch / med,
        }


# ------------------------------------------------------------ card timers


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn() on the card: CUDA events around reps runs, after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernel_ms(prof, names) -> dict:
    """name -> the device ms of each launch of the port's kernel ``name``
    in a profiled run, in launch order: the profiler's kernel events, read
    by name."""
    from torch.autograd import DeviceType

    out = {name: [] for name in names}
    for e in sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        for name in names:
            if f"{name}_kernel" in e.name:
                out[name].append(e.time_range.elapsed_us() / 1e3)
    return out


class PartTimer:
    """CUDA events around each named part of a step; ``ms(name)`` the mean
    over the steps after the first (its cuDNN and allocator warm-up)."""

    def __init__(self):
        self.events = {}

    def __call__(self, name):
        @contextlib.contextmanager
        def part():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.events.setdefault(name, []).append((start, end))

        return part()

    def ms(self, name):
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) for s, e in self.events.get(name, [])]
        return float(np.mean(times[1:] if len(times) > 1 else times)) if times else 0.0

    def steps(self, name):
        return len(self.events.get(name, []))


def peak_gib(fn):
    """(fn(), the peak device memory of the call in GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def synced_ms(fn):
    """(fn(), its wall ms between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3
