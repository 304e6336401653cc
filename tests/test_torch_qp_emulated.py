"""Kernels 5-8 of ``sdf_nmpc_tpu_torch/csrc/qp_solve.cu`` run on the CPU in an
emulation of the CUDA execution model, against the plain versions of
``ops/qp_kernels.py`` at the card tests' tolerances (tests/test_torch_gpu.py).

The emulation (``tests/_torch_port.py``: ``CUDA_RUNTIME_H``,
``build_emulated``) compiles the CUDA source with g++ against a stub
``cuda_runtime.h``: each CUDA thread a ``std::thread``, the blocks one after
the other, ``__syncthreads`` / ``__syncwarp`` as ``std::barrier``s, shuffles
through a per-warp exchange buffer, shared memory poisoned with NaN before
each block, the cp.async copies synchronous.  The package's own wrappers
(``_factor_solve_cuda`` and its siblings) call the emulated library through
ctypes on CPU tensors.  The same harness builds other sources (another tree's
``qp_solve.cu``, or ``ip_phase.cu`` with a ``cudaLaunchKernel`` defined after
it) to compare two builds' outputs bit for bit.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from _torch_port import CSRC, build_emulated, load_emulated, use_emulated
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

@pytest.fixture(scope="module")
def emulated_qp(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation of qp_solve.cu")
    return load_emulated(build_emulated(CSRC / "qp_solve.cu", tmp_path_factory.mktemp("qp")))


def _system(n, k, r, seed, B=4):
    """As tests/test_torch_gpu.py::_spd_system: A = G G' + 10 I, Cs rows,
    ds_inv = 1 / eta_s with eta_s in [1e2, 1e6], f32."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    s = dict(A=np.einsum("bij,bkj->bik", G, G) + 10 * np.eye(n), RHS=rng.normal(size=(B, r, n)),
             Cs=rng.normal(size=(B, k, n)), dsi=1.0 / 10.0 ** rng.uniform(2, 6, size=(B, k)),
             R2=rng.normal(size=(B, r, n)))
    return {key: torch.as_tensor(v, dtype=torch.float32) for key, v in s.items()}


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


SHAPES = [(17, 1), (17, 3), (80, 1), (80, 3)]


@pytest.mark.parametrize("n, r", SHAPES)
def test_factor_solve_and_solve_emulated(emulated_qp, monkeypatch, n, r):
    """Kernels 5 and 6: X within 1e-4 and L within 1e-5 of their largest
    entries of the plain version, L zero above the diagonal."""
    from sdf_nmpc_tpu_torch.ops import qp_kernels as qk

    use_emulated(monkeypatch, emulated_qp)
    s = _system(n, 8, r, seed=[n, r, 5])
    X, L = qk._factor_solve_cuda(s["A"], s["RHS"])
    X2 = qk._solve_cuda(L, s["R2"])
    Xp, Lp = qk.factor_solve_plain(s["A"], s["RHS"])
    assert _rel(X, Xp) < 1e-4 and _rel(L, Lp) < 1e-5
    assert _rel(X2, qk.solve_plain(Lp, s["R2"])) < 1e-4
    assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.parametrize("n, r", SHAPES)
def test_stiff_factor_solve_and_resolve_emulated(emulated_qp, monkeypatch, n, r):
    """Kernels 7 and 8 at k=8: X and the re-solve within 2e-3 of their
    largest entries (eta_s up to 1e6), Xs 1e-4, L 1e-5, Lt 1e-4; L and Lt
    zero above the diagonal; the launch geometry of both."""
    from sdf_nmpc_tpu_torch.ops import qp_kernels as qk

    use_emulated(monkeypatch, emulated_qp)
    k = 8
    s = _system(n, k, r, seed=[n, r, 7])
    X, (L, Xs, Lt) = qk._stiff_factor_solve_cuda(s["A"], s["RHS"], s["Cs"], s["dsi"])
    X2 = qk._stiff_resolve_cuda(L, Xs, Lt, s["Cs"], s["R2"])
    Xp, (Lp, Xsp, Ltp) = qk.stiff_factor_solve_plain(s["A"], s["RHS"], s["Cs"], s["dsi"])
    assert _rel(X, Xp) < 2e-3 and _rel(Xs, Xsp) < 1e-4
    assert _rel(L, Lp) < 1e-5 and _rel(Lt, Ltp) < 1e-4
    assert _rel(X2, qk.stiff_resolve_plain(Lp, Xsp, Ltp, s["Cs"], s["R2"])) < 2e-3
    assert bool((torch.triu(L, 1) == 0).all()) and bool((torch.triu(Lt, 1) == 0).all())
    ld = n | 1
    geo7, geo8 = qk.stiff_factor_solve_geometry(n, r, k), qk.stiff_resolve_geometry(n, r, k)
    assert geo7["threads"] == geo8["threads"] == 128
    assert geo7["smem_bytes"] == 4 * (ld * (n + r + k) + max(4 * 72, k * (k + 2 * r)))
    assert geo8["smem_bytes"] == 4 * (ld * (n + r + 2 * k) + k * (k + 8))
