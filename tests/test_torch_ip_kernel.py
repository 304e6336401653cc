"""Kernel 4 (ip_phase) and the fused solve around it: the plain version
against the JAX whole-phase Pallas kernel (interpret mode, f32) and the JAX
solve_qp with XLA Cholesky (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, t32, t64  # noqa: F401  (fixtures)


def _qp(B, nz, nc, seed=3):
    """A soft-constrained QP batch built as in tests/test_qp_kernels.py."""
    RNG = np.random.default_rng(seed)
    A = RNG.normal(size=(B, nz, nz))
    H = np.einsum("bij,bkj->bik", A, A) + 10 * np.eye(nz)
    return dict(H=H, g=RNG.normal(size=(B, nz)) * 2, C=RNG.normal(size=(B, nc, nz)),
                c0=RNG.normal(size=(B, nc)), lh=np.full((B, nc), -0.1),
                uh=np.full((B, nc), 0.1), z1=np.full((B, nc), 1e3),
                z2=np.full((B, nc), 1e4), lb=np.full((B, nz), -0.7),
                ub=np.full((B, nz), 0.7))


ORDER = ("H", "g", "C", "c0", "lh", "uh", "z1", "z2", "lb", "ub")


@pytest.mark.parametrize("iters,n_warm", [(12, 8), (10, 10), (20, 12)])
def test_plain_f32_matches_fused_pallas_interpret(iters, n_warm):
    """The JAX fused-kernel test's shapes and tolerance
    (tests/test_qp_kernels.py): nz=16, nc=10, k_stiff=8, dz 1e-4, for its
    12 + 4 schedule, a warm-only one and the cold budget's 12 + 8 split.
    This QP family sits at the f32 interior point's noise floor: on some
    draws the JAX package's own f32 XLA path and its fused kernel differ by
    up to 5e-4.  So dz is held to 1e-4 or, where larger, twice that
    in-package spread on the same inputs."""
    from sdf_nmpc_tpu.ops.ip_kernel import make_fused_solve as jfused
    from sdf_nmpc_tpu.solver.qp import QpData as JQ
    from sdf_nmpc_tpu.solver.qp import solve_qp as jsolve
    from sdf_nmpc_tpu_torch.ops.ip_kernel import make_fused_solve as tfused

    q = {k: v.astype(np.float32) for k, v in _qp(4, 16, 10).items()}
    kw = dict(iters=iters, n_warm=n_warm, k_stiff=8, mu0=0.1, box_margin=1e-6)
    want = jax.jit(jax.vmap(jfused(**kw)))(*[jnp.asarray(q[k]) for k in ORDER])
    xla = jax.jit(jax.vmap(lambda qq: jsolve(
        qq, iters=iters, stiff_iters=iters - n_warm, k_stiff=8, chol_impl="xla",
        ir_steps=0)))(JQ(**{k: jnp.asarray(v) for k, v in q.items()}))
    spread = float(np.abs(np.asarray(xla.dz) - np.asarray(want[0])).max())
    got = tfused(**kw)(*[t32(q[k]) for k in ORDER])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=max(1e-4, 2 * spread))  # dz
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-2)  # kkt
    # duals feed warm starts only: the JAX test's loose check
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0.1, atol=1e-3)


def _cold_state(q):
    """solver/qp.py's cold start (warm_duals=None), mu0 = 0.1."""
    B, nz = q["g"].shape
    width = q["ub"] - q["lb"]
    dz = np.clip(np.zeros_like(q["lb"]), q["lb"] + 1e-6 * (1 + width),
                 q["ub"] - 1e-6 * (1 + width))
    w0 = q["c0"] + np.einsum("bcz,bz->bc", q["C"], dz)
    sl = np.maximum(q["lh"] - w0, 0.0) + 0.1
    su = np.maximum(w0 - q["uh"], 0.0) + 0.1
    mu0 = 0.1
    st = [dz, sl, su, mu0 / (w0 + sl - q["lh"]), mu0 / (q["uh"] + su - w0), mu0 / sl,
          mu0 / su, mu0 / (dz - q["lb"]), mu0 / (q["ub"] - dz), np.full(B, mu0), dz,
          np.full(B, np.inf), np.zeros_like(dz)]
    return [a.astype(np.float32) for a in st]


@pytest.mark.parametrize("k_s,n_iters,it0,n_tail", [(0, 8, 0, 0), (8, 4, 8, 4)])
def test_plain_phase_matches_pallas_phase_interpret(k_s, n_iters, it0, n_tail):
    """One phase from a common state, kernel against plain, every state
    field: the warm phase from the cold start, and a stiff phase from the
    JAX kernel's own state after that warm phase.  dz-like fields 1e-4; the
    slacks, duals, mu and best merit at the JAX fused test's loose 10% (rows
    at the f32 floor carry ill-determined duals)."""
    from sdf_nmpc_tpu.ops.ip_kernel import ip_phase_lanes
    from sdf_nmpc_tpu_torch.ops.ip_kernel import ip_consts, ip_phase

    B = 3
    q = {k: v.astype(np.float32) for k, v in _qp(B, 16, 10).items()}
    consts = ip_consts(torch.float32, 1e8)
    jorder = ("H", "C", "g", "c0", "lh", "uh", "z1", "z2", "lb", "ub")

    def lanes(a):  # the TPU layout: batch last, padded to 128 lanes with copies
        a = np.resize(a, (128,) + a.shape[1:])
        return jnp.asarray(np.moveaxis(a, 0, -1) if a.ndim > 1 else a[None])

    def unlanes(a):
        a = np.moveaxis(np.asarray(a), -1, 0)[:B]
        return a[:, 0] if a.shape[1:] == (1,) else a

    def jphase(st, ks, n, i0, nt):
        return jax.jit(lambda d, s: ip_phase_lanes(d, s, ks, n, i0, consts, interpret=True,
                                                   n_tail=nt))(
            tuple(lanes(q[k]) for k in jorder), tuple(lanes(a) for a in st))

    state = _cold_state(q)
    if k_s:  # start the stiff phase where the JAX warm phase ended
        state = [unlanes(a) for a in jphase(state, 0, 8, 0, 0)]
    want = [unlanes(a) for a in jphase(state, k_s, n_iters, it0, n_tail)]
    got = ip_phase(tuple(t32(q[k]) for k in jorder), tuple(t32(a) for a in state), k_s,
                   n_iters, it0, consts, n_tail=n_tail)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = dict(atol=1e-4) if i in (0, 10, 12) else dict(rtol=0.1, atol=1e-3)
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"state field {i}", **tol)


def test_plain_f64_matches_solve_qp_xla():
    """f64: the port's solve_qp (plain phases) against the JAX solve_qp with
    XLA Cholesky, warm and stiff phases, best iterate and tail average."""
    from sdf_nmpc_tpu.solver.qp import QpData as JQ
    from sdf_nmpc_tpu.solver.qp import solve_qp as jsolve
    from sdf_nmpc_tpu_torch.solver.qp import QpData as TQ
    from sdf_nmpc_tpu_torch.solver.qp import solve_qp as tsolve

    q = _qp(4, 16, 10)
    kw = dict(iters=14, stiff_iters=6, k_stiff=8, mu0=0.1, box_margin=1e-6)
    want = jax.jit(jax.vmap(lambda qq: jsolve(qq, chol_impl="xla", ir_steps=0, **kw)))(
        JQ(**{k: jnp.asarray(v) for k, v in q.items()}))
    got = tsolve(TQ(**{k: t64(v) for k, v in q.items()}), **kw)
    np.testing.assert_allclose(got.dz.numpy(), np.asarray(want.dz), atol=1e-9, rtol=1e-9)
    # the KKT diagnostic reads the final duals of near-active rows, which
    # carry barrier ratios up to ~1e10 even in f64
    np.testing.assert_allclose(got.kkt_residual.numpy(), np.asarray(want.kkt_residual),
                               atol=1e-5)
    np.testing.assert_allclose(got.complementarity.numpy(),
                               np.asarray(want.complementarity), rtol=1e-6)


def test_unsupported_settings_raise():
    """The JAX package's other linear-algebra routes ('xla', 'custom') run
    the composed path since their port (tests/test_torch_linalg.py), and a
    chol_impl the JAX package does not name raises, naming the values; warm
    duals and refinement take the composed path
    (tests/test_torch_qp_composed.py)."""
    from sdf_nmpc_tpu_torch.solver.qp import QpData, solve_qp

    q = QpData(**{k: t64(v) for k, v in _qp(2, 8, 4).items()})
    for impl in ("xla", "custom"):
        assert torch.isfinite(solve_qp(q, chol_impl=impl).dz).all()
    with pytest.raises(ValueError, match="custom"):
        solve_qp(q, chol_impl="cusolver")