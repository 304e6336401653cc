"""The frozen operation and byte counts against ``chip_smoke.py``'s
functions at the same shapes (the counts were copied from there; the
frozen copies take the interior point's budget from the configuration)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from portbench.yardstick import counts, peaks

ROOT = Path(__file__).resolve().parents[2]
CONF = json.loads((ROOT / "portbench/configs/config4_att_sdf.json").read_text())


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("nz, nc, ks", [(80, 63, 0), (80, 63, 8), (160, 123, 8), (80, 68, 48)])
def test_ip_ops_per_iter(smoke, nz, nc, ks):
    assert counts.ip_ops_per_iter(nz, nc, ks) == smoke.ip_ops_per_iter(nz, nc, ks)


@pytest.mark.parametrize("B", [1, 8, 32768])
def test_sdf_rows(smoke, B):
    z = counts.sizes(CONF)
    s1, s2, s3, s4 = z["layers"]
    nemb, L = z["nemb"], z["L"]
    shapes = {"W1": (nemb + L, s1), "b1": (s1,), "W2": (s1, s2), "b2": (s2,),
              "W3": (s2 + nemb + L, s3), "b3": (s3,), "W4": (s3, s4), "b4": (s4,),
              "W5": (s4, 1), "b5": (1,)}
    packed = {k: torch.empty(s) for k, s in shapes.items()}
    packed.update(nemb=nemb, L=L, sizes=(s1, s2, s3, s4))
    P = B * z["N"]
    ops, bytes_ = smoke.sdf_cost((packed, torch.empty(P, 3), torch.empty(P, L)))
    assert counts.sdf_rows(CONF, B) == (ops, bytes_)
    assert nemb == 83  # 3 + 5 frequencies x 8 octahedron directions x (sin, cos)


@pytest.mark.parametrize("B", [2, 8192])
def test_condense(smoke, B):
    z = counts.sizes(CONF)
    N, nx, nu, ny, nh = z["N"], z["nx"], z["nu"], z["ny"], z["nh"]
    e = lambda *s: torch.empty(*s)
    args = (e(B, N, nx, nx), e(B, N, nx, nu), e(B, N, nx), e(B, nx), e(B, N, ny, nx),
            e(B, N, ny, nu), e(B, N, ny), e(B, N, nh, nx), e(B, N, nh, nu), e(B, N, nh))
    assert counts.condense(CONF, B) == smoke.condense_cost(args)


def test_qp_phases_follow_the_budget():
    assert counts.qp_phases(CONF, "steady") == [(0, 11), (8, 4)]
    assert counts.qp_phases(CONF, "cold") == [(0, 12), (8, 8)]
    B = 8192
    (o1, b1), (o2, b2) = counts.qp(CONF, B)
    assert o1 == B * 11 * counts.ip_ops_per_iter(80, 63, 0)
    assert o2 == B * 4 * counts.ip_ops_per_iter(80, 63, 8)
    # PERF.md section 6: kernel 4's bound 1.340 ms per B=8192 steady step, operations
    assert counts.qp_bound_s(CONF, B) * 1e3 == pytest.approx(1.340, abs=5e-4)
    assert counts.sdf_bound_s(CONF, B) * 1e3 == pytest.approx(2.032, abs=5e-4)


def test_budget_matches_the_program():
    """The configuration file's budgets are the ones the program's 'auto'
    settings resolve for this OCP."""
    from sdf_nmpc_tpu_torch.solver.sqp import _budget_knobs

    from portbench.systems.rti_step import program_config

    cfg = program_config(CONF)
    for budget in ("cold", "steady"):
        iters, k, stiff, cap = _budget_knobs(cfg, budget)
        b = CONF["qp"]["budgets"][budget]
        assert (iters, k, stiff) == (b["iters"], CONF["qp"]["k_stiff"], b["stiff_iters"])
        assert cap == CONF["qp"]["ratio_cap_float32"]


def test_step_peak_parts():
    B = 32768
    t = counts.step_peak_s(CONF, B)
    parts = (3 * counts.sdf_rows(CONF, B)[0] / peaks.TF32 + counts.condense(CONF, B)[0] / peaks.FP32
             + counts.gram(CONF, B)[0] / peaks.FP64_TENSOR
             + sum(o for o, _ in counts.qp(CONF, B)) / peaks.FP32)
    assert t == pytest.approx(parts)
    assert 0.010 < t < 0.025
