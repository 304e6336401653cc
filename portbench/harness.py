"""The benchmark harness, driven by data.

``BENCHMARK.json`` names the cells (``workloads``), their configurations
and traffic mixes, and the metrics.  Everything that belongs to one of them
sits in a file of its own, found by its name:

* ``configs/<config>.json`` (the file the configuration entry names): the
  configuration's sizes and its ``system``, the module under ``systems/``
  that builds the program, its inputs and its comparison with the plain
  reference (``reference/``);
* ``traffic/<traffic>.json``: the mix's parameters, read by the one
  generator in ``driver.py``;
* ``metrics/<metric>.py``: a reader ``read(ctx)`` that returns the metric
  or None where the run has nothing for it to read;
* ``limits/<workload>.json``: the limits of the numbers that decide the
  cell's ``correct``.

A run: set-up (configuration, inputs from the seed, the program, its first
calls), the window of ``seconds``, with ``--trace 1`` a short profiled
window, then the comparison with the reference, then one JSON line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import driver
from portbench.yardstick import counts, peaks, stats, trace as trace_mod

ROOT = Path(__file__).resolve().parents[1]
PB = "portbench"
JAX_NAMES = ("jax", "jaxlib", "flax", "optax", "sdf_nmpc_tpu")


class HarnessError(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def bench(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def entry(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise HarnessError(f"no {what} named {name!r} in BENCHMARK.json")


def config_of(b: dict, workload: dict, root: Path = ROOT) -> dict:
    c = entry(b["configs"], workload["config"], "configuration")
    return load_json(root / c["file"])


def traffic_of(workload: dict, root: Path = ROOT) -> dict:
    return load_json(root / PB / "traffic" / f"{workload['traffic']}.json")


def limits_of(workload: dict, root: Path = ROOT) -> dict:
    return load_json(root / PB / "limits" / f"{workload['name']}.json")


def reader(name: str, root: Path = ROOT):
    """The reader module of metric ``name`` (``metrics/<name>.py``), loaded
    by its path: metric names hold dots."""
    path = root / PB / "metrics" / f"{name}.py"
    if not path.exists():
        raise HarnessError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system_of(conf: dict):
    return importlib.import_module(f"portbench.systems.{conf['system']}")


def cell_metrics(b: dict, workload: str, traced: bool) -> list:
    """The metric entries a run of the cell reports: end to end with
    ``--trace 0``, per layer with ``--trace 1``.  An entry with a
    ``workloads`` list applies to those cells; a per-layer entry without one
    to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in b["end_to_end"] if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in b["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def jax_modules() -> list:
    """Modules of the JAX stack or the JAX package loaded in this process,
    compared by whole top-level names."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(JAX_NAMES))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


class Ctx:
    """What a metric reader reads: the cell, its configuration and traffic,
    the window, the trace, the set-up time, the memory peak and the
    yardstick."""

    counts = counts
    peaks = peaks
    stats = stats

    def __init__(self, **kw):
        self.trace = None
        self.__dict__.update(kw)


def profile_window(units: int, run_unit, device) -> trace_mod.Trace:
    """A profiled steady window of ``units`` units, ended by a synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    driver.sync(device)
    with profile(activities=acts) as prof:
        with record_function(trace_mod.WINDOW):
            for _ in range(units):
                run_unit()
            driver.sync(device)
    return trace_mod.from_profile(prof, units)


def run(workload: str, seed: int, seconds: float, traced: bool, device="cuda", root=ROOT,
        t_start=None, sizes=None, overrides=None, wrap=None, log=None, cache=None,
        fault=None, ranks=None):
    """One run of a cell.  Returns (result dict, check lines, every number
    of the comparison).  ``sizes`` overrides traffic parameters (the tests'
    small runs on the CPU); ``overrides`` the program's solver settings (the
    controls of ``readings.py``); ``wrap`` the program's step (the tests'
    planted faults; ``fault`` names it for the other ranks of a sharded
    cell, ``portbench/tests/faults.py``); ``cache`` a dict that keeps the
    program built from one run to the next in one process (and, under
    ``"cell"``, the last run's cell); ``ranks`` the (port, processes) of a
    sharded cell's other ranks, where the caller started them
    (``portbench/rank.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    root = Path(root)
    b = bench(root)
    wl = entry(b["workloads"], workload, "workload")
    conf, traffic, limits = config_of(b, wl, root), traffic_of(wl, root), limits_of(wl, root)
    traffic = {**traffic, **(sizes or {})}
    metrics = cell_metrics(b, workload, traced)
    readers = {m["name"]: reader(m["name"], root) for m in metrics}

    cell = system_of(conf).Cell(conf, traffic, seed, device, root, overrides=overrides,
                                wrap=wrap, cache=cache)
    if cache is not None:
        cache["cell"] = cell
    cell.run_args = dict(workload=workload, seconds=seconds, traced=traced,
                         sizes=json.dumps(sizes) if sizes else None, fault=fault, ranks=ranks)
    try:
        cell.setup()
        device = cell.device  # a rank of a sharded cell takes its own card
        units = cell.fixed_units(seconds) if traffic["loop"] == "chain" else None
        driver.sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        cell.start_window()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s; window of {seconds} s")
        log("set-up marks (s from the process's start): " + ", ".join(
            f"{k} {t - t_start:.2f}" for k, t in cell.marks.items()))
        if traffic["loop"] == "chain":
            win = driver.run_chain(cell.unit, seconds, device, units)
        else:
            win = driver.run_ticks(cell.tick, seconds, device)
        failed = cell.failed()
        spans = cell.spans()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        win.wall_s, peak = cell.reduce_window(win.wall_s, peak)
        log(f"window: {win.units} units in {win.wall_s:.3f} s, {failed} failed, peak "
            f"{peak / 2**30:.3f} GiB")
        log("window quarters (units/s): " + " ".join(f"{r:.3f}" for r in win.quarters()))

        tr = None
        if traced:
            unit = cell.unit if traffic["loop"] == "chain" else (lambda: cell.tick(None))
            tr = profile_window(int(traffic["profile_units"]), unit, device)
        busy = None if tr is None else cell.reduce_busy(tr.busy_s())
        t_check = time.perf_counter()
        cell.check_step()
        if not cell.is_root:
            return None, [], {}
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = cell.numbers(device)
        cell.finish()
        log(f"comparison with the reference: {time.perf_counter() - t_check:.3f} s")
    except BaseException:
        cell.abort()
        raise

    ctx = Ctx(workload=wl, conf=conf, traffic=traffic, B=cell.B,
              B_card=cell.B // int(wl["chips"]), window=win, trace=tr,
              setup_s=setup_s, peak_bytes=peak, seconds=seconds, spans=spans)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    check, lines = {}, []
    for name, lim in limits["limits"].items():
        v = numbers[name]
        check[name] = {"value": v, "limit": lim}
        lines.append(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    correct = all(c["value"] <= c["limit"] for c in check.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": int(win.units * cell.B),
              "failed": int(failed), "metrics": values, "device": dev}
    if tr is not None:
        dev["busy_s"] = busy
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.top_idle_gaps()}
    result["check"] = check
    return result, lines, numbers
