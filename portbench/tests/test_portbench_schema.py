"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the run-time budget, and that every cell's configuration, traffic
mix, limits and metric readers are found by name."""

from __future__ import annotations

import json
import math
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    cmd = B["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    files = [w for w in cmd if "/" in w]
    assert files and all(any(w.startswith(p + "/") for p in B["paths"]) for w in files)


def test_run_seconds_fits_the_full_check():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    used = {w["config"] for w in B["workloads"]}
    files = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        assert (ROOT / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


def test_workloads():
    ws = B["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    four = sum(w["chips"] == 4 for w in ws)
    assert four <= max(1, math.floor(0.25 * len(ws)))
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert line(w["why"])


def _metric_common(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for w in m.get("workloads", []):
        assert w in {x["name"] for x in B["workloads"]}


def test_end_to_end():
    e2e = B["end_to_end"]
    assert 1 <= len(e2e) <= 16
    names = [m["name"] for m in e2e]
    assert "setup_s" in names
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        _metric_common(m)
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in B["workloads"]:
        got = [m["name"] for m in e2e if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in got and len(got) >= 2


def test_per_layer():
    pl = B["per_layer"]
    assert 1 <= len(pl) <= 128
    e2e = {m["name"]: m for m in B["end_to_end"]}
    layers = {}
    for m in pl:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        _metric_common(m)
        assert line(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or "roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in B["workloads"]:
        assert harness.cell_metrics(B, w["name"], True), w["name"]


def test_unique_names():
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(names)) == len(names)
    assert len({c["name"] for c in B["configs"]}) == len(B["configs"])


@pytest.mark.parametrize("w", [w["name"] for w in B["workloads"]])
def test_every_cell_finds_its_files(w):
    wl = harness.entry(B["workloads"], w, "workload")
    conf = harness.config_of(B, wl, ROOT)
    traffic = harness.traffic_of(wl, ROOT)
    limits = harness.limits_of(wl, ROOT)
    assert harness.system_of(conf).Cell
    assert traffic["loop"] in ("chain", "tick")
    assert limits["limits"] and all(v >= 0 for v in limits["limits"].values())
    for traced in (False, True):
        for m in harness.cell_metrics(B, w, traced):
            assert callable(harness.reader(m["name"], ROOT).read)
