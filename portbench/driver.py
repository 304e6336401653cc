"""The one traffic generator: closed loops over a cell's units of work, as
its traffic file's parameters say.

``loop: "chain"`` issues unit after unit with nothing read back; the host
may run at most ``AHEAD`` units in front of the card (a CUDA event per unit),
and the window ends with a synchronize.  ``loop: "tick"`` runs one tick at a
time, each ending with its answers on the host; every tick is timed from the
end of the one before it.  Both loops stop issuing once ``seconds`` have
passed on the host's clock, and both count all the work and all the time of
the window.
"""

from __future__ import annotations

import time

import torch

AHEAD = 2  # units a chain may have waiting in the card's queue


class Window:
    """What a window measured: units done, its wall seconds, per tick the
    seconds of the tick and of the host's issue of its step, and per unit
    the host's clock (from the window's start) when the loop moved past it."""

    def __init__(self):
        self.units = 0
        self.wall_s = 0.0
        self.tick_s: list = []
        self.issue_s: list = []
        self.unit_t: list = []

    def quarters(self) -> list:
        """Units per second in each quarter of the window (the loop's clock:
        a chain's unit is counted when it was issued)."""
        q = self.wall_s / 4
        if q <= 0:
            return []
        n = [0] * 4
        for t in self.unit_t:
            n[min(3, int(t / q))] += 1
        return [k / q for k in n]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_chain(unit, seconds: float, device, units=None) -> Window:
    """``unit()`` issues one unit of work; at most ``AHEAD`` units wait in
    the card's queue.  ``units``: a fixed count in place of the clock (the
    ranks of a sharded cell must all run the same steps)."""
    w = Window()
    events = []
    sync(device)
    t0 = time.perf_counter()
    more = ((lambda: time.perf_counter() - t0 < seconds) if units is None
            else (lambda: w.units < units))
    while more():
        if len(events) >= AHEAD:
            events.pop(0).synchronize()
        unit()
        w.units += 1
        w.unit_t.append(time.perf_counter() - t0)
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
    sync(device)
    w.wall_s = time.perf_counter() - t0
    return w


def run_ticks(tick, seconds: float, device) -> Window:
    """``tick(window)`` runs one tick and returns once its answers are on
    the host; it records its step's host issue time in the window."""
    w = Window()
    sync(device)
    t0 = last = time.perf_counter()
    while last - t0 < seconds:
        tick(w)
        now = time.perf_counter()
        w.tick_s.append(now - last)
        w.unit_t.append(now - t0)
        last = now
        w.units += 1
    w.wall_s = last - t0
    return w
