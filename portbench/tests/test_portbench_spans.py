"""The nine span metrics (``metrics/*``, ``yardstick/spans.py``) on a
synthetic ``Trace`` whose spans, runtime calls and device gaps are known, on
traces without the program's spans, and on a profiler's trace of real
spans."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.yardstick import spans
from portbench.yardstick.trace import Trace

FLEET = ("step_host_ms.fleet", "rows_host_ms.fleet", "qp_host_ms.fleet", "step_wait_ms.fleet",
         "step_launches.fleet", "kernel_host_ms.fleet", "idle_in_step_ms.fleet")
SWEEP = ("step_wait_ms.sweep", "idle_in_step_ms.sweep")
STAGES = ((1.0, 1.5), (1.5, 2.0), (2.0, 2.2), (2.2, 2.5), (2.5, 3.0), (3.0, 3.8), (3.8, 3.9))


def synthetic() -> Trace:
    """A window [0, 10] s of two units; each a step of 3 s whose seven
    stages take 0.5, 0.5, 0.2 (rows 1.2 s) and 0.3, 0.5, 0.8, 0.1 (QP 1.7
    s); kernel spans of 0.1 s (one condense, two ip_phase a step); blocking
    calls of 0.2 and 0.1 s inside the steps and one of 0.5 s outside;
    launches 4 inside step 1, 3 inside step 2 (one a copy), 2 outside;
    device gaps of 0.1 and 0.5 s inside step 1 and three outside."""
    host = []
    for t0 in (0.0, 4.0):
        host.append(("nmpc.step", 1.0 + t0, 4.0 + t0))
        host += [(n, a + t0, b + t0) for n, (a, b) in zip(spans.STAGES, STAGES)]
        host += [("nmpc.kernel.condense", 2.3 + t0, 2.4 + t0),
                 ("nmpc.kernel.ip_phase", 3.1 + t0, 3.2 + t0),
                 ("nmpc.kernel.ip_phase", 3.3 + t0, 3.4 + t0)]
    host += [("cudaStreamSynchronize", 1.6, 1.8), ("cudaMemcpyAsync", 5.6, 5.7),
             ("cudaDeviceSynchronize", 9.0, 9.5),
             ("cudaLaunchKernel", 1.1, 1.11), ("cudaLaunchKernel", 2.35, 2.36),
             ("cudaLaunchKernelExC", 3.15, 3.16), ("cuLaunchKernel", 3.35, 3.36),
             ("cudaLaunchKernel", 6.35, 6.36), ("cudaMemsetAsync", 7.15, 7.16),
             ("cudaLaunchKernel", 4.5, 4.51), ("cuLaunchKernelEx", 0.5, 0.51),
             ("aten::mul", 1.05, 1.2), ("aten::copy_", 5.55, 5.75)]
    dev = [("k0", 0.5, 1.2), ("k1", 1.3, 2.0), ("k2", 2.5, 4.6), ("k3", 5.2, 9.0),
           ("k4", 9.1, 10.5)]
    return Trace(device_ops=dev, host_ops=host, start=0.0, end=10.0, units=2)


# by hand: per unit, the window's sums over 2 units
EXPECTED = {
    "step_host_ms.fleet": 3000.0,  # 2 x 3 s
    "rows_host_ms.fleet": 1200.0,  # 2 x (0.5 + 0.5 + 0.2) s
    "qp_host_ms.fleet": 1700.0,  # 2 x (0.3 + 0.5 + 0.8 + 0.1) s
    "step_wait_ms.fleet": 150.0,  # 0.2 + 0.1 s; the synchronize at 9 s is outside
    "step_launches.fleet": 3.5,  # 1.1, 2.35, 3.15, 3.35, 5.6 (the copy), 6.35, 7.15
    "kernel_host_ms.fleet": 300.0,  # 6 x 0.1 s
    # gaps [1.2, 1.3] and [2.0, 2.5]; [0, 0.5], [4.6, 5.2] and [9.0, 9.1] lie outside
    "idle_in_step_ms.fleet": 300.0,
    "step_wait_ms.sweep": 150.0,
    "idle_in_step_ms.sweep": 300.0,
}


def read(name, trace):
    return harness.reader(name).read(harness.Ctx(trace=trace))


@pytest.mark.parametrize("name", FLEET + SWEEP)
def test_reader_on_a_synthetic_trace(name):
    assert read(name, synthetic()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", FLEET + SWEEP)
def test_reader_without_a_trace_or_a_step(name):
    """None with no trace, with a trace that holds no ``nmpc.`` span, and
    with one whose spans hold no ``nmpc.step``: never 0."""
    tr = synthetic()
    assert read(name, None) is None
    plain = Trace(tr.device_ops, [h for h in tr.host_ops if not h[0].startswith("nmpc.")],
                  tr.start, tr.end, tr.units)
    assert read(name, plain) is None
    no_step = Trace(tr.device_ops, [h for h in tr.host_ops if h[0] != "nmpc.step"],
                    tr.start, tr.end, tr.units)
    assert read(name, no_step) is None


def test_the_sums_nest():
    """step_wait_ms <= step_host_ms and rows_host_ms + qp_host_ms <=
    step_host_ms, here and when a stage or a blocking call overruns its step."""
    tr = synthetic()
    over = Trace(tr.device_ops, tr.host_ops + [("nmpc.step.update", 3.85, 4.3),
                                               ("cudaStreamSynchronize", 3.9, 4.4)],
                 tr.start, tr.end, tr.units)
    for t in (tr, over):
        step = read("step_host_ms.fleet", t)
        assert read("step_wait_ms.fleet", t) <= step
        assert read("rows_host_ms.fleet", t) + read("qp_host_ms.fleet", t) <= step + 1e-9


def test_idle_gaps_are_the_trace_s_own():
    """The gaps the idle metric sums are ``Trace.top_idle_gaps``'s."""
    tr = synthetic()
    assert sorted(b - a for a, b in spans.idle_gaps(tr)) == pytest.approx(
        sorted(v for _, v in tr.top_idle_gaps(100)))


def test_stage_table():
    """Per span: host ms, launches, blocking calls and idle ms per unit."""
    rows = {r[0]: r[1:] for r in spans.stage_table(synthetic())}
    assert list(rows)[:8] == ["nmpc.step", *spans.STAGES]
    assert rows["nmpc.step"] == pytest.approx([3000.0, 3.5, 1.0, 300.0])
    assert rows["nmpc.step.lin"] == pytest.approx([500.0, 0.5, 0.0, 50.0])
    assert rows["nmpc.step.rows"] == pytest.approx([500.0, 0.5, 1.0, 0.0])
    assert rows["nmpc.step.condense"] == pytest.approx([300.0, 1.0, 0.0, 250.0])
    assert rows["nmpc.kernel.ip_phase"] == pytest.approx([200.0, 1.5, 0.0, 0.0])
    assert spans.stage_table(None) is None


def test_spans_of_a_profiled_window():
    """Real FUNCTION-scope spans through ``torch.profiler`` and
    ``trace.from_profile``: the step metrics read them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.yardstick import trace as trace_mod
    from sdf_nmpc_tpu_torch.utils.timing import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace_mod.WINDOW):
            for _ in range(2):
                with span("nmpc.step"):
                    with span("nmpc.step.lin"):
                        x = torch.ones(64, 64) @ torch.ones(64, 64)
                    with span("nmpc.step.qp"):
                        x = x + 1
    tr = trace_mod.from_profile(prof, 2)
    step = read("step_host_ms.fleet", tr)
    assert step is not None and step > 0
    assert 0 < read("rows_host_ms.fleet", tr) + read("qp_host_ms.fleet", tr) <= step
    assert read("step_launches.fleet", tr) == 0
    assert read("idle_in_step_ms.fleet", tr) is None  # no device in the trace
