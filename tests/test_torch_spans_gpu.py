"""The port's profiler spans on the card.  Every test here is marked
``gpu`` and skips without a CUDA device; the file imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_spans_gpu.py

One steady config-4 step at B = 1024 under ``torch.profiler``: no ``nmpc.``
name is a device event (the spans are FUNCTION-scope ranges, which Kineto
does not mirror onto the device's timeline), and the ``nmpc.kernel.*``
spans agree with ``_lib.launch_counts``.  The sync census: the source lines
of the program that block the host on the card (``torch.cuda.
set_sync_debug_mode("warn")``) in one steady step (none) and one config-3
tick; one steady step under the debug mode's "error" setting, which builds
no kept constant (``utils/device_consts.py``).
"""

import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)

PKG = Path(__file__).resolve().parents[1] / "sdf_nmpc_tpu_torch"
B = 1024
FRAMES = 256  # config 3's frames a tick; their latents tiled over the step's B
KERNELS = {"lin_y_sens": 1, "sdf_fused_x3": 1, "condense": 1, "ip_phase": 2}
# the synchronizing calls of the program in one steady config-4 step, each
# "file::function: source line" with its count per step: none, since every
# index and constant the step reads is on the card before it runs; a
# config-3 tick adds the range map's copy.  A change that adds one updates
# these and PERF.md's census.
STEP_SYNCS = {}
TICK_SYNCS = {
    "sdf_nmpc_tpu_torch/perception/preprocessing.py::_map_like: "
    "return torch.as_tensor(depth2range_map(H, W, hfov, vfov), device=img.device)": 1,
}
SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture(scope="module")
def steady_step():
    """(cfg, steady step, its state after a cold and two steady steps,
    inputs) of config 4 at B = 1024 on the card."""
    from sdf_nmpc_tpu_torch.entry import build
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host: pytest -m gpu)")
    cfg, ocp, cold, state, inputs = build(batch=B, device="cuda")
    steady = make_rti_step(ocp, cfg, budget="steady", with_evals=False)
    res = cold(state, inputs)
    for _ in range(2):
        res = steady(res.state, inputs)
    torch.cuda.synchronize()
    return cfg, steady, res.state, inputs


@pytest.fixture(scope="module")
def profiled(steady_step):
    """(the profiler's events of one steady step, the launch counts it
    added)."""
    from torch.profiler import ProfilerActivity, profile

    from sdf_nmpc_tpu_torch.ops import _lib

    _, steady, state, inputs = steady_step
    before = dict(_lib.launch_counts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steady(state, inputs)
        torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _lib.launch_counts.items() if v != before[k]}
    return list(prof.events()), counts


@pytest.mark.gpu
def test_no_span_is_a_device_event(profiled):
    """The step's spans are on the host's timeline alone; the device's
    events are its kernels and copies."""
    from torch.autograd import DeviceType

    events, _ = profiled
    host = [e.name for e in events if e.device_type == DeviceType.CPU]
    dev = [e.name for e in events if e.device_type == DeviceType.CUDA]
    assert host.count("nmpc.step") == 1 and "nmpc.step.qp" in host
    assert any("ip_phase_kernel" in n for n in dev)
    assert [n for n in dev if n.startswith("nmpc.")] == []


@pytest.mark.gpu
def test_kernel_spans_equal_the_launch_counts(profiled):
    """One ``nmpc.kernel.<key>`` span per launch counted: kernels 1, 2
    (f32x3), 3 once and kernel 4 twice in a steady step."""
    events, counts = profiled
    spans = Counter(e.name[len("nmpc.kernel."):] for e in events
                    if e.name.startswith("nmpc.kernel."))
    assert counts == KERNELS
    assert dict(spans) == counts


def _census(fn):
    """Count of each "file::function: line" of the package whose call
    synchronized with the card in ``fn()`` (the innermost frame of the
    package on the stack; another frame where none is)."""
    found = Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):  # not, e.g., the mode's own prototype notice
            return
        frames = [f for f in traceback.extract_stack()
                  if Path(f.filename).resolve().is_relative_to(PKG)]
        f = frames[-1] if frames else traceback.FrameSummary(filename, lineno, "?")
        rel = Path(f.filename).resolve().relative_to(PKG.parent) if frames else f.filename
        found[f"{rel}::{f.name}: {(f.line or '').strip()}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(found)


@pytest.mark.gpu
def test_sync_census(steady_step, cuda_device):
    """One steady step has no synchronizing call, and one config-3 tick
    (256 uint16 frames on the card through ``clip_distance``,
    ``depth2range``, the trained encoder, the latents into p, the step) has
    those of TICK_SYNCS alone, with their counts."""
    from sdf_nmpc_tpu_torch.perception import clip_distance, depth2range
    from sdf_nmpc_tpu_torch.utils import accuracy

    cfg, steady, state, inputs = steady_step
    s = cfg.sensor
    enc = accuracy.config3_encoder(cfg, torch.float32, cuda_device)
    rng = np.random.default_rng(3)
    frames = torch.as_tensor(rng.uniform(500, 6000, size=(FRAMES, 1, 270, 480))
                             .astype(np.uint16).astype(np.float32), device=cuda_device)
    lat = inputs.p.shape[-1] - int(cfg.nn.size_latent)
    p = inputs.p.clone()

    def tick():
        with torch.no_grad():
            x = depth2range(clip_distance(frames, s.dmax, s.mm_resolution), s.hfov, s.vfov)
            z = enc(x)
        p[..., lat:] = z.repeat(B // FRAMES, 1)[:, None, :]
        return steady(state, inputs._replace(p=p))

    step = _census(lambda: steady(state, inputs))
    tick = _census(tick)
    print("step:", step)
    print("tick:", tick)
    assert step == STEP_SYNCS == {}
    assert tick == {**STEP_SYNCS, **TICK_SYNCS}


@pytest.mark.gpu
def test_steady_step_is_sync_free(steady_step):
    """One steady step under ``set_sync_debug_mode("error")``, where any
    synchronizing call raises, reads kept constants and builds none."""
    from sdf_nmpc_tpu_torch.utils import device_consts

    _, steady, state, inputs = steady_step
    torch.cuda.synchronize()
    device_consts.reset_kept_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = steady(state, inputs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = dict(device_consts.kept_counts)
    print("kept:", counts)
    assert counts["built"] == 0 and counts["reused"] > 0
    assert bool(torch.isfinite(res.u0).all())
