"""The port's profiler spans on the CPU (``utils.timing.span``): the step's
``nmpc.step`` and its seven stages on both QP backends, the kernel
wrappers' ``nmpc.kernel.<key>`` beside their launch counts, the perception
and scale-out spans, their scope, and outputs that do not depend on the
profiler."""

import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from torch.profiler import ProfilerActivity, profile, record_function

STAGES = ("nmpc.step.lin", "nmpc.step.rows", "nmpc.step.terminal", "nmpc.step.condense",
          "nmpc.step.gram", "nmpc.step.qp", "nmpc.step.update")
FUNCTION_SCOPE = 0  # torch.autograd's RecordScope.FUNCTION, the scope of aten:: operators
USER_SCOPE = 7  # RecordScope.USER_SCOPE, torch.profiler.record_function's


def _small(N=None):
    """(cfg, ocp, steady step, state after a cold step, inputs): config 4's
    step at B = 4 with a seeded 4 x 16 network on the CPU."""
    from sdf_nmpc_tpu_torch.entry import build
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    over = None if N is None else {"mpc": {"N": N, "T": 1.5 * N / 20}}
    cfg, ocp, cold, state, inputs = build(over, latent=16, layer_sizes=(16,) * 4, batch=4,
                                          device="cpu")
    steady = make_rti_step(ocp, cfg, budget="steady", with_evals=False)
    return cfg, ocp, steady, cold(state, inputs).state, inputs


@pytest.fixture(scope="module")
def small():
    return _small()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("nmpc.")]


def _inside(child, parent):
    return (parent.time_range.start <= child.time_range.start
            and child.time_range.end <= parent.time_range.end)


def _check_steps(events, n_steps):
    """``n_steps`` disjoint ``nmpc.step`` spans, each with exactly the seven
    stage spans inside it, in order."""
    steps = sorted((e for e in events if e.name == "nmpc.step"), key=lambda e: e.time_range.start)
    assert len(steps) == n_steps
    for a, b in zip(steps, steps[1:]):
        assert a.time_range.end <= b.time_range.start
    stages = [e for e in events if e.name.startswith("nmpc.step.")]
    assert len(stages) == 7 * n_steps
    for st in steps:
        kids = sorted((e for e in stages if _inside(e, st)), key=lambda e: e.time_range.start)
        assert tuple(e.name for e in kids) == STAGES
        assert all(e.cpu_parent is not None and e.cpu_parent.name == "nmpc.step" for e in kids)
        for a, b in zip(kids, kids[1:]):
            assert a.time_range.end <= b.time_range.start


@pytest.mark.parametrize("sqp_iters", [1, 2])
def test_steady_step_has_one_step_span_per_sqp_iteration(sqp_iters, small):
    """The condensed backend: one ``nmpc.step`` per SQP iteration, the
    seven stages in order inside each."""
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    cfg, ocp, _, state, inputs = small
    steady = make_rti_step(ocp, cfg.replace(solver={"sqp_iters": sqp_iters}), budget="steady",
                           with_evals=False)
    _, events = _profiled(lambda: steady(state, inputs))
    _check_steps(events, sqp_iters)


def test_riccati_step_has_the_same_spans():
    """N = 24 takes the Riccati backend ('auto' beyond N = 20): the same
    ``nmpc.step`` and seven stages."""
    from sdf_nmpc_tpu_torch.solver.sqp import resolve_qp_backend

    cfg, _, steady, state, inputs = _small(N=24)
    assert resolve_qp_backend(cfg, cfg.mpc.N) == "riccati"
    _, events = _profiled(lambda: steady(state, inputs))
    _check_steps(events, 1)


def test_step_outputs_equal_with_the_profiler_on_and_off(small):
    """The spans change no number: a steady step from the same state gives
    the same bits with and without a running profiler."""
    from sdf_nmpc_tpu_torch.utils.timing import tensor_leaves

    _, _, steady, state, inputs = small
    off = steady(state, inputs)
    on, events = _profiled(lambda: steady(state, inputs))
    assert events
    a, b = tensor_leaves(off), tensor_leaves(on)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_perception_spans():
    """``clip_distance``, ``depth2range`` and ``Encoder.forward`` each open
    their span once per call."""
    from sdf_nmpc_tpu_torch.nn.vae import Encoder
    from sdf_nmpc_tpu_torch.perception import clip_distance, depth2range

    enc = Encoder(size_latent=8, generator=torch.Generator().manual_seed(0)).eval()
    frames = torch.full((2, 1, 36, 64), 2500.0)

    def tick():
        with torch.no_grad():
            x = depth2range(clip_distance(frames, 5.0, 1000), 1.5, 1.0)
            return enc(x)

    z, events = _profiled(tick)
    assert z.shape == (2, 8)
    assert sorted(e.name for e in events) == [
        "nmpc.perception.clip", "nmpc.perception.encoder", "nmpc.perception.range"]


def test_batched_step_without_a_mesh_opens_the_stats_span(small):
    """``make_batched_step`` without a mesh: the step's spans, then
    ``nmpc.scaleout.stats`` around the BatchStats reduction."""
    from sdf_nmpc_tpu_torch.parallel import make_batched_step

    cfg, ocp, _, state, inputs = small
    batched = make_batched_step(ocp, cfg, budget="steady")
    (res, stats), events = _profiled(lambda: batched(state, inputs))
    assert int(stats.n_ok) + int(stats.n_failed) == res.status.shape[0]
    _check_steps(events, 1)
    step = next(e for e in events if e.name == "nmpc.step")
    red = [e for e in events if e.name == "nmpc.scaleout.stats"]
    assert len(red) == 1 and red[0].time_range.start >= step.time_range.end


def test_kernel_launch_span_and_count_agree():
    """``_lib.launch``: one ``nmpc.kernel.<key>`` span and one more launch
    counted per block; a block that raises opens its span and counts
    nothing."""
    from sdf_nmpc_tpu_torch.ops import _lib

    before = dict(_lib.launch_counts)

    def run():
        for _ in range(2):
            with _lib.launch("condense"):
                pass
        with pytest.raises(RuntimeError):
            with _lib.launch("ip_phase"):
                raise RuntimeError("no launch")

    _, events = _profiled(run)
    assert sorted(e.name for e in events) == [
        "nmpc.kernel.condense", "nmpc.kernel.condense", "nmpc.kernel.ip_phase"]
    assert _lib.launch_counts["condense"] == before["condense"] + 2
    assert _lib.launch_counts["ip_phase"] == before["ip_phase"]


def test_every_span_has_the_function_scope(small):
    """Every ``nmpc.`` event is a FUNCTION-scope range, as the ``aten::``
    operators: never the USER scope of ``record_function``, which Kineto
    mirrors onto the device's timeline."""
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.parallel import make_batched_step
    from sdf_nmpc_tpu_torch.perception import clip_distance, depth2range

    cfg, ocp, _, state, inputs = small
    batched = make_batched_step(ocp, cfg, budget="steady")

    def run():
        batched(state, inputs)
        depth2range(clip_distance(torch.ones(4, 6), 5.0), 1.5, 1.0)
        with _lib.launch("condense"):
            pass
        with record_function("nmpc.user_probe"):  # the scope the spans must not take
            pass

    _, events = _profiled(run)
    probe = [e for e in events if e.name == "nmpc.user_probe"]
    assert len(probe) == 1 and probe[0].scope == USER_SCOPE
    spans = [e for e in events if e.name != "nmpc.user_probe"]
    assert len({e.name for e in spans}) == 12
    assert {e.scope for e in spans} == {FUNCTION_SCOPE}


def test_span_records_nothing_without_a_profiler():
    """Outside a profiler the span is inert: the body runs, nothing is kept."""
    from sdf_nmpc_tpu_torch.utils.timing import span

    with span("nmpc.step"):
        x = torch.ones(3) + 1
    assert torch.equal(x, torch.full((3,), 2.0))
