"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a small size, once for each fault the cells can have, and for the control
(the program's own bf16 path for the QP data, which runs on the CPU too).
The same run unbroken comes out correct."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.faults import ALL, faults_of

SIZES = {"scenarios": 8, "check_rows": 8, "warm_units": 1, "profile_units": 1,
         "frame_sets": 2}
CELLS = ("c4_sweep_b32768", "c3_fleet_b256", "c4_fleet_b8192")


@pytest.fixture(scope="module")
def cache():
    torch.set_num_threads(2)
    return {}


def run(cell, cache, **kw):
    res, lines, numbers = harness.run(cell, 2**31 + 5, 0.3, False, device="cpu", sizes=SIZES,
                                      log=lambda m: None, cache=cache, **kw)
    return res, lines, numbers


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, cache):
    res, lines, _ = run(cell, cache)
    assert res["correct"], lines
    assert list(res)[-1] == "check" and all(line.endswith(" ok") for line in lines)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ALL, ids=lambda f: f.__name__)
def test_fault_is_not_correct(cell, fault, cache):
    fault = faults_of(cell, fault)
    res, lines, _ = run(cell, cache, wrap=fault)
    assert not res["correct"], lines
    assert any(line.endswith("FAILED") for line in lines)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cache):
    res, lines, numbers = run(cell, cache, overrides={"qp_data_bf16": True})
    assert not res["correct"], (lines, numbers)
