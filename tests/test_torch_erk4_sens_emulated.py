"""Kernel 9 (``sdf_nmpc_tpu_torch/csrc/erk4_sens.cu``: two tangent
directions per thread as one ``Dual2`` sweep, the block's inputs and outputs
staged through shared memory) run on the CPU in the g++ emulation of the
CUDA execution model (``tests/_torch_port.py``), through the package's own
wrapper ``_erk4_sens_cuda``, against ``erk4_sens_plain`` for all six
families: rates, wrench and props, and the instances of att, acc and
att_tau (their dynamics from ``csrc/quad_dyn.cuh``) that the step takes
under sdf_cost.

37 points: two whole blocks of 16 and a partial one.  A missing barrier, a
wrong slab offset, a column stored in the wrong place or a ninth lane that
writes its empty second direction shows as a disagreement (shared memory is
poisoned with NaN before each block).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from _torch_port import CSRC, build_emulated, load_emulated, t32, use_emulated

ERK4_TOL = 1e-4  # chip_smoke.py: per output, max |kernel - plain| <= 1e-4 (1 + max |plain|)


@pytest.fixture(scope="module")
def emulated_erk4(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation of erk4_sens.cu")
    out = tmp_path_factory.mktemp("erk4_sens")
    return load_emulated(build_emulated(CSRC / "erk4_sens.cu", out))


def _points(M, nx, seed):
    """As tests/test_torch_gpu.py::_points: tilts within ~25 degrees, body
    rates ~0.5, inputs inside the box."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, nx)) * 0.5
    x[:, 3:7] = np.array([1.0, 0, 0, 0]) + rng.normal(size=(M, 4)) * 0.2
    u = rng.uniform(-0.9, 0.9, size=(M, 4))
    u[:, 0] = rng.uniform(0.1, 0.9, size=M)
    return [t32(a) for a in (x, u, rng.uniform(0.01, 0.1, size=M))]


@pytest.mark.parametrize("model", ["rates", "wrench", "props", "att", "acc", "att_tau"])
def test_erk4_sens_emulated(emulated_erk4, monkeypatch, model):
    """x+, A and B each within ERK4_TOL (1 + its largest magnitude) of the
    plain version, exactly one launch counted; the launch geometry: 16
    points of (nx + 5) / 2 threads, their inputs and outputs in shared
    memory."""
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.models import make_model
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.ops import lin_kernels as lk
    from sdf_nmpc_tpu_torch.utils.accuracy import family_config

    use_emulated(monkeypatch, emulated_erk4)
    spec = make_model(family_config(default_config(), model))
    args = _points(37, spec.nx, seed=[37, len(model)])
    before = _lib.launch_counts["erk4_sens"]
    got = lk._erk4_sens_cuda(spec, *args)
    assert _lib.launch_counts["erk4_sens"] == before + 1
    for name, g, w in zip(("x+", "A", "B"), got, lk.erk4_sens_plain(spec, *args)):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        lim = ERK4_TOL * (1 + float(w.abs().max()))
        assert float((g - w).abs().max()) <= lim, (name, float((g - w).abs().max()), lim)
    nx = spec.nx
    assert lk.erk4_sens_geometry(spec) == {
        "threads": 16 * ((nx + 5) // 2),
        "smem_bytes": 16 * 4 * (nx + 5 + nx + nx * nx + 4 * nx),
        "blocks_per_sm": min(2048 // (16 * ((nx + 5) // 2)),
                             233472 // (16 * 4 * (nx + 5 + nx + nx * nx + 4 * nx) + 1024))}
