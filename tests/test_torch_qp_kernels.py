"""Kernels 5-8 (ops/qp_kernels.py): the plain versions against the JAX lanes
kernels in interpret mode (f32, n=80, k=8) and against the JAX
single-scenario primals (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import one_torch_thread, t32, t64  # noqa: F401  (fixtures)

N_LANES = 128  # one lane tile, the batch tests/test_qp_kernels.py interprets
B = 4  # real scenarios; the rest of the lane tile repeats them


def _system(n, k, r, seed):
    """A seeded SPD batch with stiff rows as the interior point builds them:
    A = G G' + 10 I, Cs rows, ds_inv = 1 / eta_s with eta_s in [1e2, 1e6]."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    A = np.einsum("bij,bkj->bik", G, G) + 10 * np.eye(n)
    return dict(A=A, RHS=rng.normal(size=(B, r, n)), Cs=rng.normal(size=(B, k, n)),
                dsi=1.0 / 10.0 ** rng.uniform(2, 6, size=(B, k)),
                R2=rng.normal(size=(B, r, n)))


def _lanes(a):
    """(B, ...) -> the lanes layout (..., 128), the batch repeated."""
    return jnp.asarray(np.moveaxis(np.resize(a, (N_LANES,) + a.shape[1:]), 0, -1), jnp.float32)


def _unlanes(a):
    return np.moveaxis(np.asarray(a), -1, 0)[:B]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("r", [1, 7])
def test_factor_solve_and_solve_plain_f32_match_lanes_interpret(r):
    """Kernels 5 and 6 at n=80, for the Newton rhs alone (r=1) and with the
    six Cs rows of an unaligned stiff split stacked under it (r=7): X within
    1e-4 of the largest |X| (tests/test_qp_kernels.py), L within 1e-5 of
    the largest |L| (one f32 factorization in another summation order)."""
    from sdf_nmpc_tpu.ops.qp_kernels import factor_solve_lanes_with_L, solve_lanes
    from sdf_nmpc_tpu_torch.ops.qp_kernels import factor_solve, solve

    s = _system(80, 8, r, seed=r)
    jX, jL = jax.jit(lambda M, R: factor_solve_lanes_with_L(M, R, interpret=True))(
        _lanes(s["A"]), _lanes(s["RHS"]))
    jX2 = jax.jit(lambda L, R: solve_lanes(L, R, interpret=True))(jL, _lanes(s["R2"]))
    X, L = factor_solve(t32(s["A"]), t32(s["RHS"]))
    X2 = solve(L, t32(s["R2"]))
    assert _rel(X.numpy(), _unlanes(jX)) < 1e-4
    assert _rel(L.numpy(), _unlanes(jL)) < 1e-5
    assert _rel(X2.numpy(), _unlanes(jX2)) < 1e-4


def test_stiff_factor_solve_and_resolve_plain_f32_match_lanes_interpret():
    """Kernels 7 and 8 at n=80, k=8, r=1: X, Xs and the re-solve within 2e-3
    relative of the largest entry (the stiff rows carry eta up to 1e6, which
    tests/test_qp_kernels.py holds at rtol 2e-3), L and Lt within 1e-5 and
    1e-4 of their largest entries."""
    from sdf_nmpc_tpu.ops.qp_kernels import stiff_factor_solve_lanes, stiff_resolve_lanes
    from sdf_nmpc_tpu_torch.ops.qp_kernels import stiff_factor_solve, stiff_resolve

    s = _system(80, 8, 1, seed=11)
    jX, jL, jXs, jLt = jax.jit(lambda *a: stiff_factor_solve_lanes(*a, interpret=True))(
        _lanes(s["A"]), _lanes(s["RHS"]), _lanes(s["Cs"]), _lanes(s["dsi"]))
    jX2 = jax.jit(lambda *a: stiff_resolve_lanes(*a, interpret=True))(
        jL, _lanes(s["Cs"]), jXs, jLt, _lanes(s["R2"]))
    X, (L, Xs, Lt) = stiff_factor_solve(t32(s["A"]), t32(s["RHS"]), t32(s["Cs"]),
                                        t32(s["dsi"]))
    X2 = stiff_resolve(L, Xs, Lt, t32(s["Cs"]), t32(s["R2"]))
    assert _rel(X.numpy(), _unlanes(jX)) < 2e-3
    assert _rel(Xs.numpy(), _unlanes(jXs)) < 1e-4
    assert _rel(X2.numpy(), _unlanes(jX2)) < 2e-3
    assert _rel(L.numpy(), _unlanes(jL)) < 1e-5
    assert _rel(Lt.numpy(), _unlanes(jLt)) < 1e-4


def test_plain_f64_match_jax_primals():
    """f64, n=16, k=8, r=2: every output of the four plain versions against
    the JAX single-scenario primals (newton_factor_solve, newton_resolve,
    stiff_factor_solve, stiff_resolve) scenario by scenario, to 1e-12 of
    the largest entry (both are LAPACK Cholesky and triangular solves)."""
    from sdf_nmpc_tpu.ops import qp_kernels as jq
    from sdf_nmpc_tpu_torch.ops import qp_kernels as tq

    s = _system(16, 8, 2, seed=5)
    X, L = tq.factor_solve(t64(s["A"]), t64(s["RHS"]))
    X2 = tq.solve(L, t64(s["R2"]))
    Y, (Ls, Xs, Lt) = tq.stiff_factor_solve(t64(s["A"]), t64(s["RHS"]), t64(s["Cs"]),
                                            t64(s["dsi"]))
    Y2 = tq.stiff_resolve(Ls, Xs, Lt, t64(s["Cs"]), t64(s["R2"]))
    for b in range(B):
        A, R, Cs, dsi, R2 = (jnp.asarray(s[k][b]) for k in ("A", "RHS", "Cs", "dsi", "R2"))
        jX, jL = jq.newton_factor_solve(A, R)
        jY, (jLs, jXs, jLt) = jq.stiff_factor_solve(A, R, Cs, dsi)
        pairs = [(X[b], jX), (L[b], jL), (X2[b], jq.newton_resolve(jL, R2)), (Y[b], jY),
                 (Ls[b], jLs), (Xs[b], jXs), (Lt[b], jLt),
                 (Y2[b], jq.stiff_resolve(jLs, jXs, jLt, Cs, R2))]
        for i, (got, want) in enumerate(pairs):
            assert _rel(got.numpy(), np.asarray(want)) < 1e-12, (b, i)


def test_failed_factorization_gives_nan_in_plain():
    """An indefinite matrix: the plain factor is NaN (jnp.linalg.cholesky's
    behaviour), so the composed path's non-finite guard sees it."""
    from sdf_nmpc_tpu_torch.ops.qp_kernels import factor_solve

    M = -np.eye(4)[None].repeat(2, 0)
    M[1] = np.eye(4)
    X, L = factor_solve(t64(M), t64(np.ones((2, 1, 4))))
    assert np.isnan(L[0].numpy()).all() and np.isnan(X[0].numpy()).all()
    np.testing.assert_allclose(X[1].numpy(), np.ones((1, 4)))
