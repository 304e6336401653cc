"""Workload helpers (the accuracy goldens) and the timers."""

from .timing import Stopwatch, ThroughputMeter, device_trace

__all__ = ["Stopwatch", "ThroughputMeter", "device_trace"]
