"""Kernels 3 and 1 (``sdf_nmpc_tpu_torch/csrc/condense.cu`` and
``csrc/lin_y_sens.cu``) run on the CPU in the g++ emulation of the CUDA
execution model (``tests/_torch_port.py``), through the package's own
wrappers ``_condense_cuda`` and ``_lin_y_sens_cuda``, against their plain
versions at the card tests' tolerances (tests/test_torch_gpu.py).

Kernel 3 runs at a small shape (nz 10: two threads of four columns, one of
two, and e; the general instance) and at the two production widths (nx 10
and 13, the compile-time instances; nz 80, float4 stores); kernel 1 on 37
points (two blocks of 16 and a partial one) per model.  A missing barrier,
a prefetch into the buffer the stage still reads, a wrong slab offset or a
store of the wrong column shows as a disagreement (shared memory is
poisoned with NaN before each block).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from _torch_port import CSRC, build_emulated, load_emulated, t32, use_emulated
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _build(tmp_path_factory, source):
    if shutil.which("g++") is None:
        pytest.skip(f"needs g++ to build the emulation of {source}")
    return load_emulated(build_emulated(CSRC / source, tmp_path_factory.mktemp(source[:-3])))


@pytest.fixture(scope="module")
def emulated_condense(tmp_path_factory):
    return _build(tmp_path_factory, "condense.cu")


@pytest.fixture(scope="module")
def emulated_lin(tmp_path_factory):
    return _build(tmp_path_factory, "lin_y_sens.cu")


def _condense_inputs(B, N, nx, nu, ny, nh, seed):
    """As tests/test_torch_gpu.py::test_condense_kernel_matches_plain: A is
    I + 0.05 noise, everything else standard normal."""
    rng = np.random.default_rng(seed)
    shapes = [(B, N, nx, nu), (B, N, nx), (B, nx), (B, N, ny, nx),
              (B, N, ny, nu), (B, N, ny), (B, N, nh, nx), (B, N, nh, nu), (B, N, nh)]
    A = np.eye(nx) + 0.05 * rng.normal(size=(B, N, nx, nx))
    return [t32(a) for a in [A] + [rng.normal(size=s) for s in shapes]]


@pytest.mark.parametrize("B, N, nx, nu, ny, nh", [
    (3, 5, 4, 2, 6, 2),
    (2, 20, 10, 4, 11, 3),
    (2, 20, 13, 4, 16, 3),
])
def test_condense_emulated(emulated_condense, monkeypatch, B, N, nx, nu, ny, nh):
    """Every output within 1e-5 absolute and relative of the plain version;
    the columns of E_k beyond k nu exactly zero; the launch geometry: a
    thread per four columns and one for e, in whole warps, and two stage
    buffers of shared memory."""
    from sdf_nmpc_tpu_torch.ops import condense_kernel as ck

    use_emulated(monkeypatch, emulated_condense)
    args = _condense_inputs(B, N, nx, nu, ny, nh, seed=[N, nx, ny])
    got = ck._condense_cuda(*args)
    want = ck.condense_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    E_st = got[1]
    for k in range(N):
        assert bool((E_st[:, k, :, k * nu:] == 0).all())
    nz, r4 = N * nu, lambda n: (n + 3) // 4 * 4
    geo = ck.condense_geometry(N, nx, nu, ny, nh)
    words = (nx + ny + nh) * r4(nx) + sum(map(r4, (nx * nu, ny * nu, nh * nu, nx, ny, nh)))
    assert geo["threads"] == ((nz + 3) // 4 + 32) // 32 * 32
    assert geo["smem_bytes"] == 2 * 4 * words


def _nonfinite_inputs():
    """_condense_inputs at nz 10 (B = 4) with a non-finite entry in one
    scenario each: NaN in A at stage 2, +Inf in Jyx at stage 1, NaN in Jhx
    at stage 3; scenario 3 finite."""
    args = _condense_inputs(4, 5, 4, 2, 6, 2, seed=11)
    args[0][0, 2, 1, 3] = float("nan")
    args[4][1, 1, 0, 2] = float("inf")
    args[7][2, 3, 1, 0] = float("nan")
    return args


def test_condense_emulated_nonfinite_as_the_jax_kernel(emulated_condense, monkeypatch):
    """Where A_k, Jyx_k or Jhx_k hold a non-finite entry, the kernel's
    outputs are NaN (and +-Inf) exactly where the plain version's and the
    JAX kernel's (interpret mode) are: E's zero columns take the products
    (0 * NaN = NaN) from that stage on.  The finite entries agree at 1e-5;
    the finite scenario is untouched."""
    import jax

    from sdf_nmpc_tpu.ops.condense_kernel import condense_nodes
    from sdf_nmpc_tpu_torch.ops import condense_kernel as ck

    use_emulated(monkeypatch, emulated_condense)
    args = _nonfinite_inputs()
    got = ck._condense_cuda(*args)
    want = ck.condense_plain(*args)
    jax_out = jax.jit(jax.vmap(condense_nodes))(*[a.numpy() for a in args])
    for g, w, j in zip(got, want, jax_out):
        j = torch.as_tensor(np.asarray(j))
        for ref in (w, j):
            assert torch.equal(torch.isnan(g), torch.isnan(ref))
            assert torch.equal(torch.isinf(g), torch.isinf(ref))
            fin = torch.isfinite(ref)
            torch.testing.assert_close(g[fin], ref[fin], rtol=1e-5, atol=1e-5)
    E_st = got[1]
    assert bool(torch.isnan(E_st[0, 3:, :, 8:]).any())  # zero columns after A's NaN
    assert bool(torch.isfinite(torch.cat([o[3].flatten() for o in got])).all())


def test_condense_refuses_sizes_beyond_the_kernel():
    """nx beyond the registers and nz beyond the threads the kernel is built
    for raise, naming the limit; no plain fallback."""
    from sdf_nmpc_tpu_torch.ops import condense_kernel as ck

    args = _condense_inputs(1, 3, ck.NX_MAX + 1, 2, 4, 1, seed=0)
    with pytest.raises(ValueError, match=f"nx <= {ck.NX_MAX}"):
        ck._condense_cuda(*args)
    args = _condense_inputs(1, ck.NZ_MAX // 4 + 1, 4, 4, 2, 1, seed=0)
    with pytest.raises(ValueError, match=f"nz = N nu <= {ck.NZ_MAX}"):
        ck._condense_cuda(*args)


def _family(model):
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.models import make_model
    from sdf_nmpc_tpu_torch.params import ParamLayout
    from sdf_nmpc_tpu_torch.utils.accuracy import family_config

    cfg = family_config(default_config(), model)
    return make_model(cfg), ParamLayout.from_cfg(cfg)


def _lin_inputs(M, lay, seed):
    """As tests/test_torch_gpu.py's kernel-1 tests: tilts within ~25
    degrees, inputs inside the box, a unit q_d, random yref."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, 10)) * 0.5
    x[:, 3:7] = np.array([1.0, 0, 0, 0]) + rng.normal(size=(M, 4)) * 0.2
    u = rng.uniform(-0.9, 0.9, size=(M, 4))
    u[:, 0] = rng.uniform(0.1, 0.9, size=M)
    p = np.zeros((M, lay.np_total))
    qd = rng.normal(size=(M, 4))
    p[:, list(lay.q_d)] = qd / np.linalg.norm(qd, axis=1, keepdims=True)
    return [t32(a) for a in (x, u, rng.uniform(0.01, 0.1, size=M), p, rng.normal(size=(M, 11)))]


@pytest.mark.parametrize("model", ["att", "acc", "att_tau"])
def test_lin_y_sens_emulated(emulated_lin, monkeypatch, model):
    """Each output (x+, A, B, res, Jyx, Jyu) held against the plain version
    in f64 on the same f32 inputs: within the absolute tolerance of
    chip_smoke.py's LIN_TOL, or twice the plain f32 version's own distance
    where that is larger (tests/test_torch_gpu.py::
    test_lin_y_sens_kernel_matches_plain_families); the launch geometry."""
    from sdf_nmpc_tpu_torch.ops import lin_kernels as lk

    use_emulated(monkeypatch, emulated_lin)
    spec, lay = _family(model)
    args = _lin_inputs(37, lay, seed=[37, len(model)])
    got = lk._lin_y_sens_cuda(spec, lay, *args)
    plain = lk.lin_y_sens_plain(spec, *args)
    f64 = lk.lin_y_sens_plain(spec, *[a.double() for a in args])
    tols = (1e-4, 1e-4, 1e-4, 2e-4, 1e-4, 1e-4)
    for name, g, w, r, tol in zip(("x+", "A", "B", "res", "Jyx", "Jyu"), got, plain, f64, tols):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        e_k = float((g.double() - r).abs().max())
        e_p = float((w.double() - r).abs().max())
        assert e_k <= max(tol, 2 * e_p), name
    assert lk.lin_y_sens_geometry(spec) == {"threads": 112, "smem_bytes": 16 * 4 * (30 + 315),
                                            "blocks_per_sm": 10}
