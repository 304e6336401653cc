"""Kernel 4 (``sdf_nmpc_tpu_torch/csrc/ip_phase.cu``: one interior-point
phase per block) run on the CPU in the g++ emulation of the CUDA execution
model (``tests/_torch_port.py``), through the package's own wrapper
``_ip_phase_cuda``, against ``ip_phase_plain``: at the main path's QP (nz 80,
nc 63, k_s 8) and at the recursive-feasibility QP's wide stiff split (nc 68,
k_s 48), where T (48 x 48) is factored and both Woodbury corrections are
applied in warp 0.

The source's launch goes through ``cudaLaunchKernel``, which the emulation
defines after the source (``EXTRA``).  Seeded random QPs of 4 scenarios as
tests/test_torch_gpu.py builds them, 8 warm iterations then 4 stiff ones;
each launch starts from the plain version's state and is held as the card
test holds it (``_as_accurate``).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from _torch_port import CSRC, build_emulated, load_emulated, t32, use_emulated
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

EXTRA = r"""
cudaError_t cudaLaunchKernel(const void* fn, dim3 grid, dim3 block, void** args, size_t smem,
                             cudaStream_t stream) {
  return emu::launch(reinterpret_cast<void (*)(PhaseArgs)>(const_cast<void*>(fn)), grid, block,
                     smem, stream, *static_cast<PhaseArgs*>(args[0]));
}
"""


@pytest.fixture(scope="module")
def emulated_ip(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation of ip_phase.cu")
    out = tmp_path_factory.mktemp("ip_phase")
    return load_emulated(build_emulated(CSRC / "ip_phase.cu", out, extra=EXTRA))


def _random_qp(B, nz, nc, rng):
    """tests/test_torch_gpu.py::_random_qp: H = A A' + 10 I, soft rows with
    bounds +-0.1, boxes +-0.7."""
    from sdf_nmpc_tpu_torch.solver.qp import QpData

    A = rng.normal(size=(B, nz, nz))
    q = dict(H=np.einsum("bij,bkj->bik", A, A) + 10 * np.eye(nz), g=rng.normal(size=(B, nz)) * 2,
             C=rng.normal(size=(B, nc, nz)), c0=rng.normal(size=(B, nc)),
             lh=np.full((B, nc), -0.1), uh=np.full((B, nc), 0.1), z1=np.full((B, nc), 1e3),
             z2=np.full((B, nc), 1e4), lb=np.full((B, nz), -0.7), ub=np.full((B, nz), 0.7))
    return QpData(**{k: t32(v) for k, v in q.items()})


def _as_accurate(label, got, want, ref):
    """tests/test_torch_gpu.py::_as_accurate: per scenario, none beyond 1e-4
    of the plain version where the plain f32 version lies within 1e-4 of
    f64; the kernel's distance to f64 with a median at most twice the plain
    version's plus 1e-7 and a largest at most 4 times plus 1e-4."""
    def dev(a, b):
        return (a.double() - b.double()).abs().reshape(a.shape[0], -1).amax(-1)

    d, d64, dk64 = dev(got, want), dev(want, ref), dev(got, ref)
    assert int(((d > 1e-4) & (d64 <= 1e-4)).sum()) == 0, (label, d, d64)
    assert float(dk64.median()) <= 2 * float(d64.median()) + 1e-7, (label, dk64, d64)
    assert float(dk64.max()) <= 4 * float(d64.max()) + 1e-4, (label, dk64, d64)


@pytest.mark.parametrize("nc, k_stiff", [(63, 8), (68, 48)])
def test_ip_phase_emulated(emulated_ip, monkeypatch, nc, k_stiff):
    """Both launches of a 12-iteration fused solve (k_s 0, then k_stiff),
    one counted launch each: dz, the slacks, the best iterate and the tail
    sum held against the plain version and f64; the launch's shared memory
    at (80, nc, k_stiff): 52,404 B at k_s 8, 76,484 B at k_s 48."""
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.ops import ip_kernel as ipk

    use_emulated(monkeypatch, emulated_ip)
    nz, B = 80, 4
    qg = _random_qp(B, nz, nc, np.random.default_rng([B, nz, nc, k_stiff]))
    consts = ipk.ip_consts(torch.float32)
    data, state = ipk.ip_init(*qg, 0.1, 1e-6, consts)  # solve_qp's mu0 and box margin
    phases, _ = ipk.ip_schedule(12, 8, k_stiff, nc)
    assert [p[0] for p in phases] == [0, k_stiff]
    for k_s, n_iters, it0, tail in phases:
        rest = (k_s, n_iters, it0, consts, tail)
        want = ipk.ip_phase_plain(data, state, *rest)
        ref = ipk.ip_phase_plain(tuple(t.double() for t in data),
                                 tuple(t.double() for t in state), *rest)
        n0 = _lib.launch_counts["ip_phase"]
        got = ipk._ip_phase_cuda(data, state, *rest)
        assert _lib.launch_counts["ip_phase"] == n0 + 1
        for name, i in (("dz", 0), ("sl", 1), ("su", 2), ("best_dz", 10), ("dz_tail_sum", 12)):
            assert bool(torch.isfinite(got[i]).all()), name
            _as_accurate(f"k_s={k_s} {name}", got[i], want[i], ref[i])
        state = want
    geo = ipk.ip_phase_geometry(nz, nc, k_stiff)
    assert geo["threads"] == 128 and geo["blocks_per_sm"] >= 1
    assert geo["smem_bytes"] == {8: 52404, 48: 76484}[k_stiff]
    print(f"(80, {nc}, {k_stiff}): {geo}")
