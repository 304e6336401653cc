"""The four-card cell's path on the CPU: four gloo ranks (rank 0 this
process, ranks 1-3 started by the harness) run a small sharded sweep; the
run is correct, and with the exchange between ranks left out (every
all-reduce a no-op, on every rank) or half of the batch left out it is
not."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests import faults

SIZES = {"scenarios": 16, "check_rows": 8, "warm_units": 1, "profile_units": 1}


def run(fault=None):
    torch.set_num_threads(2)
    return harness.run("c5_sweep_4x25600", 2**31 + 21, 1.0, False, device="cpu", sizes=SIZES,
                       wrap=getattr(faults, fault) if fault else None, fault=fault,
                       log=lambda m: None)


def test_sharded_run_is_correct():
    res, lines, numbers = run()
    assert res["correct"], lines
    assert numbers["stats_gap"] == 0 and res["device"]["count"] == 4
    assert res["attempted"] % 16 == 0


@pytest.mark.parametrize("fault", ["no_exchange", "half"])
def test_sharded_fault_is_not_correct(fault):
    res, lines, _ = run(fault)
    assert not res["correct"], lines
