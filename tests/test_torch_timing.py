"""The port's timing helpers and package top level against the JAX
package's: ``Stopwatch`` and ``ThroughputMeter`` on one injected clock,
``device_trace`` on the CPU, ``cache_dir`` and the lazy exports."""

import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def clock(monkeypatch):
    """time.perf_counter replaced by a clock that advances by an irregular
    seeded step on every read; each call of ``clock()`` restarts it."""
    def restart():
        steps = np.random.default_rng(5).uniform(1e-4, 3e-2, size=1000)
        ticks = itertools.accumulate(steps, initial=100.0)
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))

    return restart


def _drive_stopwatch(sw, leaf):
    for name, block in (("encode", None), ("solve", leaf), ("encode", leaf), ("host", None),
                        ("solve", {"u0": leaf, "state": [leaf, (leaf,)]})):
        with sw.stage(name, block_on=block):
            pass
    return sw.summary()


def test_stopwatch_matches_jax_on_one_clock(clock):
    """The same stages on the same clock: the same keys and values."""
    import jax.numpy as jnp

    from sdf_nmpc_tpu.utils import Stopwatch as JaxStopwatch
    from sdf_nmpc_tpu_torch.utils import Stopwatch

    clock()
    want = _drive_stopwatch(JaxStopwatch(), jnp.ones(3))
    clock()
    got = _drive_stopwatch(Stopwatch(), torch.ones(3))
    assert list(got) == list(want) == ["encode", "solve", "host"]
    for name in want:
        assert got[name].keys() == want[name].keys() == {"total_s", "count", "mean_ms"}
        for key in want[name]:
            assert got[name][key] == pytest.approx(want[name][key], rel=1e-12, abs=0), (name, key)


def test_throughput_meter_matches_jax_on_one_clock(clock):
    import jax.numpy as jnp

    from sdf_nmpc_tpu.utils import ThroughputMeter as JaxMeter
    from sdf_nmpc_tpu_torch.utils import ThroughputMeter

    def drive(meter, leaf):
        for i in range(7):
            with meter.step(block_on=None if i % 3 else (leaf, [leaf])):
                pass
        return meter.stats()

    clock()
    want = drive(JaxMeter(64), jnp.ones(3))
    clock()
    got = drive(ThroughputMeter(64), torch.ones(3))
    assert got.keys() == want.keys() == {"steps", "median_step_ms", "p99_step_ms", "solves_per_s"}
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key


def test_tensor_leaves_walks_nested_structures():
    from sdf_nmpc_tpu_torch.solver import SolverState
    from sdf_nmpc_tpu_torch.utils.timing import tensor_leaves

    a, b, c = torch.ones(1), torch.zeros(2), torch.ones(3)
    tree = {"x": a, "y": [1.0, (b, None)], "z": SolverState(X=c, U=a)}
    assert [t.shape for t in tensor_leaves(tree)] == [a.shape, b.shape, c.shape, a.shape]
    assert tensor_leaves(np.ones(3)) == []


def test_device_trace_writes_a_trace_and_stops_on_error(tmp_path):
    """On the CPU the trace holds the CPU ops; a body that raises still
    leaves a written trace and the profiler stopped."""
    from sdf_nmpc_tpu_torch.utils import device_trace

    with device_trace(tmp_path / "ok"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list((tmp_path / "ok").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)

    with pytest.raises(ValueError, match="body"):
        with device_trace(tmp_path / "raised"):
            torch.ones(8).sum()
            raise ValueError("body")
    assert len(list((tmp_path / "raised").glob("*.pt.trace.json"))) == 1
    assert not torch.autograd.profiler._is_profiler_enabled
    with device_trace(tmp_path / "again"):  # a profiler left running would refuse this
        torch.ones(8).sum()


def test_cache_dir_as_the_jax_package(tmp_path, monkeypatch):
    """SDF_NMPC_TPU_CACHE when set, else ~/.cache/sdf_nmpc_tpu; created."""
    import sdf_nmpc_tpu
    import sdf_nmpc_tpu_torch

    monkeypatch.setenv("SDF_NMPC_TPU_CACHE", str(tmp_path / "env" / "cache"))
    assert sdf_nmpc_tpu_torch.cache_dir() == sdf_nmpc_tpu.cache_dir() == tmp_path / "env" / "cache"
    assert (tmp_path / "env" / "cache").is_dir()
    monkeypatch.delenv("SDF_NMPC_TPU_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    want = tmp_path / "home" / ".cache" / "sdf_nmpc_tpu"
    assert sdf_nmpc_tpu_torch.cache_dir() == sdf_nmpc_tpu.cache_dir() == want
    assert want.is_dir()


def test_lazy_exports_cost_only_torch():
    """``import sdf_nmpc_tpu_torch`` loads none of the four modules; each
    name then resolves to the module's object, and an unknown one raises."""
    code = """
import json, sys
import sdf_nmpc_tpu_torch as m
before = sorted(k for k in sys.modules if k.startswith("sdf_nmpc_tpu_torch."))
from sdf_nmpc_tpu_torch.controller import Nmpc
from sdf_nmpc_tpu_torch.ocp import build_ocp
from sdf_nmpc_tpu_torch.config import default_config, load_config
same = [m.Nmpc is Nmpc, m.build_ocp is build_ocp, m.default_config is default_config,
        m.load_config is load_config]
try:
    m.no_such_name
    missing = False
except AttributeError:
    missing = True
print(json.dumps({"before": before, "same": same, "missing": missing,
                  "name": m.default_config().name}))
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["before"] == [], out["before"]
    assert out["same"] == [True] * 4 and out["missing"] and out["name"] == "default"
