"""The harness is driven by data: a cell and a metric added as files and
BENCHMARK.json entries, in a copy of the benchmark, are found and run
without an edit to any file that was there."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_a_new_cell_and_metric_are_found_and_reported(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_out", "_cache"))
    (tmp_path / "weights").mkdir()
    for f in ("sdf.msgpack", "latents.npy"):
        shutil.copy(ROOT / "weights" / f, tmp_path / "weights" / f)
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}

    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "c4_fleet_b4", "config": "config4_att_sdf",
                           "traffic": "fleet_b4", "chips": 1, "why": "a throwaway cell"})
    b["end_to_end"][[m["name"] for m in b["end_to_end"]].index("fleet_solves_per_s")][
        "workloads"].append("c4_fleet_b4")
    b["per_layer"].append({"name": "units.throwaway", "unit": "ticks", "better": "higher",
                           "source": "host_clock", "layer": "the traffic driver",
                           "moves": "fleet_solves_per_s", "workloads": ["c4_fleet_b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "portbench/traffic/fleet_b4.json").write_text(json.dumps(
        {"loop": "tick", "scenarios": 4, "warm_units": 1, "profile_units": 1, "check_rows": 4}))
    (tmp_path / "portbench/limits/c4_fleet_b4.json").write_text(json.dumps(
        {"limits": {"not_ok": 0}}))
    (tmp_path / "portbench/metrics/units.throwaway.py").write_text(
        '"""units.throwaway: ticks in the window."""\n\n\ndef read(ctx):\n'
        '    return ctx.window.units\n')

    nb = harness.bench(tmp_path)
    assert [m["name"] for m in harness.cell_metrics(nb, "c4_fleet_b4", True)] == [
        "units.throwaway"]
    assert "fleet_solves_per_s" in [m["name"] for m in harness.cell_metrics(nb, "c4_fleet_b4",
                                                                             False)]
    torch.set_num_threads(1)
    res, lines, _ = harness.run("c4_fleet_b4", 11, 0.3, True, device="cpu", root=tmp_path,
                                log=lambda m: None)
    assert res["correct"] and res["metrics"]["units.throwaway"]["value"] >= 1
    assert lines == [f"check not_ok 0 limit 0 ok"]
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed
