"""Card-only cases (marker ``gpu``; they skip without a CUDA card): whole
runs of each one-card cell at a reduced size through the kernels: a sound
run is correct; each planted fault and each of the program's lower-precision
controls is not.  The controls at the cells' own sizes are read by
``portbench/readings.py`` (PERF.md gives the readings and the limits).

    python -m pytest -m gpu portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.readings import CONTROLS
from portbench.tests.faults import ALL, faults_of

pytestmark = pytest.mark.gpu
SIZES = {
    "c4_sweep_b32768": {"scenarios": 4096, "check_rows": 1024},
    "c3_fleet_b256": {"scenarios": 64, "check_rows": 64, "frame_sets": 2},
    "c4_fleet_b8192": {"scenarios": 4096, "check_rows": 1024},
}


@pytest.fixture(scope="module")
def cache():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return {}


def run(cell, cache, **kw):
    return harness.run(cell, 2**32 + 77, 2.0, False, device="cuda", sizes=SIZES[cell],
                       log=lambda m: None, cache=cache, **kw)


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct(cell, cache):
    res, lines, _ = run(cell, cache)
    assert res["correct"], lines
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


@pytest.mark.parametrize("cell", sorted(SIZES))
@pytest.mark.parametrize("fault", ALL, ids=lambda f: f.__name__)
def test_fault_is_not_correct(cell, fault, cache):
    res, lines, _ = run(cell, cache, wrap=faults_of(cell, fault))
    assert not res["correct"], lines


CELL_CONTROLS = [(c, k) for c in sorted(SIZES) for k in ("sdf_bf16", "qp_bf16")]
CELL_CONTROLS.append(("c3_fleet_b256", "encoder_tf32"))


@pytest.mark.parametrize("cell, control", CELL_CONTROLS)
def test_control_is_not_correct(cell, control, cache):
    res, lines, numbers = run(cell, cache, overrides=CONTROLS[control])
    assert not res["correct"], (lines, numbers)
