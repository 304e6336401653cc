"""Reduction of a ``torch.profiler`` trace of a short steady window to what
the per-layer readers take: the device's operations as (name, start, end)
in seconds, the host's, and the window itself."""

from __future__ import annotations

from dataclasses import dataclass

from . import stats

WINDOW = "portbench.profiled_window"  # the record_function around the profiled window
# ranges the profiler mirrors onto the device's timeline that are no operation of
# its own: the window's annotation, c10d's collective annotations ("nccl:all_reduce")
ANNOTATIONS = ("portbench.", "nccl:", "gloo:")


@dataclass
class Trace:
    device_ops: list  # (name, start_s, end_s) of every kernel, copy and fill
    host_ops: list  # (name, start_s, end_s) of the host's operators and runtime calls
    start: float
    end: float
    units: int  # steps or ticks in the window

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device: the union of
        their intervals inside the window."""
        return stats.union_length(self._clipped())

    def _clipped(self):
        return [(max(s, self.start), min(e, self.end)) for _, s, e in self.device_ops
                if e > self.start and s < self.end]

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def kernel_s(self, names) -> float:
        """Summed device seconds of the kernels whose name contains one of
        ``names``."""
        return sum(e - s for n, s, e in self.device_ops if any(k in n for k in names))

    def top_device_ops(self, n: int = 10):
        tot: dict = {}
        for name, s, e in self.device_ops:
            tot[name] = tot.get(name, 0.0) + (e - s)
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]

    def top_idle_gaps(self, n: int = 10):
        """The longest idle stretches of the device, each named by the
        innermost host operation running at its middle."""
        out = []
        for a, b in stats.gaps(self._clipped(), self.start, self.end):
            mid = 0.5 * (a + b)
            around = [(e - s, name) for name, s, e in self.host_ops if s <= mid <= e]
            label = min(around)[1] if around else "host idle"
            out.append([label, b - a])
        return sorted(out, key=lambda kv: -kv[1])[:n]


def from_profile(prof, units: int) -> Trace:
    """A Trace of a finished ``torch.profiler.profile`` whose window is
    marked by ``record_function(WINDOW)``."""
    from torch.autograd import DeviceType

    dev, host, win = [], [], None
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(ANNOTATIONS):
                dev.append((e.name, s, t))
        elif e.name == WINDOW:
            win = (s, t)
        else:
            host.append((e.name, s, t))
    if win is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW!r} range")
    return Trace(device_ops=dev, host_ops=host, start=win[0], end=win[1], units=units)
