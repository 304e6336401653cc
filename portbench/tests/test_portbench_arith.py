"""The metric arithmetic on synthetic inputs: the union of device intervals
and the idle share, the tail over all ticks, the rate over the window, and
the readers on a made-up run."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import driver, harness
from portbench.yardstick import stats
from portbench.yardstick.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
CONF = json.loads((ROOT / "portbench/configs/config4_att_sdf.json").read_text())


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 11.0)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.gaps(iv, 0.0, 12.0) == [(2.0, 3.0), (4.0, 10.0), (11.0, 12.0)]
    assert stats.union_length([]) == 0.0
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


@pytest.mark.parametrize("q", [0.5, 0.9, 0.95, 0.99])
def test_quantile_is_numpys_linear(q):
    v = np.random.default_rng(3).exponential(size=997)
    assert stats.quantile(v, q) == pytest.approx(float(np.quantile(v, q)))


def test_rate_over_the_window():
    assert stats.rate(32768 * 80, 20.0) == 131072.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_trace_idle_share_and_breakdown():
    dev = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("k1", 3.0, 4.0), ("copy", 3.5, 3.6)]
    host = [("aten::item", 1.9, 3.2), ("step", 0.0, 5.0)]
    tr = Trace(device_ops=dev, host_ops=host, start=0.0, end=5.0, units=2)
    assert tr.busy_s() == pytest.approx(3.0)
    assert tr.idle_share() == pytest.approx(0.4)
    assert tr.kernel_s(("k1",)) == pytest.approx(2.0)
    assert tr.top_device_ops()[0] == ["k1", 2.0]
    gaps = tr.top_idle_gaps()
    # (2, 3) under the innermost host op at its middle, then (4, 5)
    assert gaps == [["aten::item", pytest.approx(1.0)], ["step", pytest.approx(1.0)]]


def _ctx(units, wall, ticks=(), issue=(), trace=None, peak=3 * 2**30, B=8192):
    w = driver.Window()
    w.units, w.wall_s, w.tick_s, w.issue_s = units, wall, list(ticks), list(issue)
    return harness.Ctx(workload={}, conf=CONF, traffic={}, B=B, B_card=B, window=w, trace=trace,
                       setup_s=12.5, peak_bytes=peak, seconds=20)


def test_end_to_end_readers():
    ticks = [0.08] * 190 + [0.2] * 10  # the tail is the tail of all ticks
    ctx = _ctx(200, 17.2, ticks=ticks, issue=[0.07] * 200)
    read = lambda n: harness.reader(n, ROOT).read(ctx)
    assert read("solves_per_s") == pytest.approx(8192 * 200 / 17.2)
    assert read("tick_ms_p95.host") == pytest.approx(1e3 * float(np.quantile(ticks, 0.95)))
    assert read("fleet_solves_per_s") == read("solves_per_s")
    assert read("peak_mem_gib") == pytest.approx(3.0)
    assert read("setup_s") == 12.5
    assert read("host_issue_ms.fleet") == pytest.approx(70.0)
    assert harness.reader("tick_ms_p95.host", ROOT).read(_ctx(5, 1.0)) is None


def test_trace_readers_are_silent_without_a_trace():
    ctx = _ctx(80, 20.0, B=32768)
    for m in B["per_layer"]:
        if m["source"] == "device_trace":
            assert harness.reader(m["name"], ROOT).read(ctx) is None, m["name"]


def test_annotations_are_no_device_work():
    """The profiler mirrors record_function ranges onto the device timeline;
    they are not operations (busy time, NCCL time)."""

    class E:
        def __init__(self, name, s, e, dev):
            from torch.autograd import DeviceType

            self.name, self.device_type = name, DeviceType.CUDA if dev else DeviceType.CPU
            self.time_range = type("R", (), {"start": s * 1e6, "end": e * 1e6})()

    from portbench.yardstick import trace

    prof = type("P", (), {"events": lambda self: [
        E(trace.WINDOW, 0.0, 1.0, False), E(trace.WINDOW, 0.0, 1.0, True),
        E("nccl:all_reduce", 0.1, 0.9, True), E("ncclDevKernel_AllReduce_Sum_f64", 0.2, 0.3, True),
        E("ip_phase_kernel", 0.5, 0.6, True)]})()
    tr = trace.from_profile(prof, units=1)
    assert tr.busy_s() == pytest.approx(0.2)
    ctx = _ctx(1, 1.0, trace=tr)
    assert harness.reader("nccl_ms.sweep", ROOT).read(ctx) == pytest.approx(100.0)


def test_roofline_readers():
    t_ip, t_sdf = 0.136, 0.0385  # seconds per step of kernels 4 and 2
    dev = [("void ip_phase_kernel<80>(PhaseArgs)", 0.0, t_ip * 3),
           ("sdf_fused_x3_kernel(X3Args)", 1.0, 1.0 + t_sdf * 3)]
    tr = Trace(device_ops=dev, host_ops=[], start=0.0, end=2.0, units=3)
    ctx = _ctx(80, 20.0, trace=tr, B=32768)
    ip = harness.reader("ip_roofline.sweep", ROOT).read(ctx)
    sdf = harness.reader("sdf_roofline.sweep", ROOT).read(ctx)
    assert ip == pytest.approx(100 * 4 * 1.340e-3 / t_ip, rel=1e-3)
    assert sdf == pytest.approx(100 * 4 * 2.032e-3 / t_sdf, rel=1e-3)
    mfu = harness.reader("step_mfu.sweep", ROOT).read(ctx)
    assert 0 < mfu < 100

