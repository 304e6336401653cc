"""solver/linalg.py (the blocked Cholesky of ``chol_impl: custom``) against
the JAX package's module, and the composed QP path on its 'xla' and
'custom' linear algebra against the JAX solve_qp on the same routes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, t32, t64  # noqa: F401  (fixtures)
from test_torch_ip_kernel import _qp


def _spd(B, n, seed):
    """tests/test_linalg.py's SPD batch: A A' / n + I."""
    A = np.random.default_rng(seed).normal(size=(B, n, n))
    return np.einsum("bij,bkj->bik", A, A) / n + np.eye(n)


@pytest.mark.parametrize("n", [16, 48])
def test_blocked_functions_match_jax_f64(n):
    """Every function of the module against the JAX one on the same f64
    inputs at 1e-12: the factor, the diagonal-block inverses and the solves
    with and without them, vector and matrix right-hand sides."""
    from sdf_nmpc_tpu.solver import linalg as J
    from sdf_nmpc_tpu_torch.solver import linalg as T

    rng = np.random.default_rng(n)
    M, rhs, R = _spd(4, n, seed=n), rng.normal(size=(4, n)), rng.normal(size=(4, n, 3))
    jL = J.cholesky_batched(jnp.asarray(M))
    tL = T.cholesky_batched(t64(M))
    jinv, tinv = J.diag_block_inverses(jL), T.diag_block_inverses(tL)
    pairs = [("cholesky_batched", tL, jL), ("diag_block_inverses", tinv, jinv)]
    for name, lin in (("", None), (" Linv", 1)):
        pairs += [(f"cho_solve_batched{name}",
                   T.cho_solve_batched(tL, t64(rhs), Linv=tinv if lin else None),
                   J.cho_solve_batched(jL, jnp.asarray(rhs), Linv=jinv if lin else None)),
                  (f"cho_solve_batched_mrhs{name}",
                   T.cho_solve_batched_mrhs(tL, t64(R), Linv=tinv if lin else None),
                   J.cho_solve_batched_mrhs(jL, jnp.asarray(R), Linv=jinv if lin else None))]
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("n", [20, 80, 100])  # incl. non-multiples of 16
def test_spd_functions_match_jax_f64(n):
    """The padded factor-and-solve entry points at 1e-12 against JAX, and
    against numpy's solve as tests/test_linalg.py holds them (1e-9)."""
    from sdf_nmpc_tpu.solver import linalg as J
    from sdf_nmpc_tpu_torch.solver import linalg as T

    rng = np.random.default_rng(n + 1)
    M, rhs, R = _spd(3, n, seed=n + 2), rng.normal(size=(3, n)), rng.normal(size=(3, n, 5))
    (tL, tinv), tn = T.spd_factor_batched(t64(M))
    (jL, jinv), jn = J.spd_factor_batched(jnp.asarray(M))
    assert tn == jn == n
    pairs = [("spd_factor_batched L", tL, jL), ("spd_factor_batched Linv", tinv, jinv),
             ("spd_factor_solve", T.spd_factor_solve((tL, tinv), n, t64(rhs)),
              J.spd_factor_solve((jL, jinv), n, jnp.asarray(rhs))),
             ("spd_factor_solve_mrhs", T.spd_factor_solve_mrhs((tL, tinv), n, t64(R)),
              J.spd_factor_solve_mrhs((jL, jinv), n, jnp.asarray(R))),
             ("spd_solve_batched", T.spd_solve_batched(t64(M), t64(rhs)),
              J.spd_solve_batched(jnp.asarray(M), jnp.asarray(rhs)))]
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0,
                                   err_msg=name)
    x_np = np.linalg.solve(M, rhs[..., None])[..., 0]
    np.testing.assert_allclose(pairs[-1][1].numpy(), x_np, atol=1e-9)


def test_f32_accuracy():
    """tests/test_linalg.py:49's rule: the f32 solve at n = 80 within 5e-4
    of numpy's f64 solve, as the JAX module's f32 solve is held."""
    from sdf_nmpc_tpu.solver import linalg as J
    from sdf_nmpc_tpu_torch.solver import linalg as T

    rng = np.random.default_rng(4)
    M, rhs = _spd(4, 80, seed=5).astype(np.float32), rng.normal(size=(4, 80)).astype(np.float32)
    x_np = np.linalg.solve(M.astype(np.float64), rhs.astype(np.float64)[..., None])[..., 0]
    got = T.spd_solve_batched(t32(M), t32(rhs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), x_np, rtol=0, atol=5e-4)
    want = np.asarray(J.spd_solve_batched(jnp.asarray(M), jnp.asarray(rhs)))
    np.testing.assert_allclose(want, x_np, rtol=0, atol=5e-4)


QP_KW = dict(iters=14, stiff_iters=6, mu0=0.1, box_margin=1e-6, ir_steps=0)


@functools.lru_cache(maxsize=None)
def _jax_routes(k_stiff):
    """The JAX solve_qp on both routes, once per k_stiff for the module."""
    from sdf_nmpc_tpu.solver.qp import QpData as JQ
    from sdf_nmpc_tpu.solver.qp import solve_qp as jsolve

    jq = JQ(**{k: jnp.asarray(v) for k, v in _qp(4, 16, 10, seed=7).items()})
    return {impl: jax.jit(jax.vmap(lambda qq: jsolve(qq, chol_impl=impl, k_stiff=k_stiff,
                                                     **QP_KW)))(jq)
            for impl in ("xla", "custom")}


@pytest.mark.parametrize("chol_impl", ["xla", "custom"])
@pytest.mark.parametrize("k_stiff", [8, 6])
def test_solve_qp_routes_match_jax(chol_impl, k_stiff):
    """solve_qp(chol_impl='xla' / 'custom') on the composed path against
    the JAX solve_qp on the same route, f64, nz 16, nc 10, 8 warm + 6 stiff
    iterations: dz at 1e-10; the complementarity and the KKT residual, which
    read the duals of near-active rows (tests/test_torch_qp_composed.py;
    one scenario ends unconverged at mu ~5), per scenario at 1e-10 (1 +
    |value|) or 10 x the spread between the JAX package's own two routes,
    whichever is larger."""
    from sdf_nmpc_tpu_torch.solver.qp import QpData as TQ
    from sdf_nmpc_tpu_torch.solver.qp import solve_qp as tsolve

    jax_out = _jax_routes(k_stiff)
    want, other = jax_out[chol_impl], jax_out["custom" if chol_impl == "xla" else "xla"]
    got = tsolve(TQ(**{k: t64(v) for k, v in _qp(4, 16, 10, seed=7).items()}),
                 chol_impl=chol_impl, k_stiff=k_stiff, **QP_KW)
    np.testing.assert_allclose(got.dz.numpy(), np.asarray(want.dz), atol=1e-10, rtol=0)
    for name in ("complementarity", "kkt_residual"):
        w, o = np.asarray(getattr(want, name)), np.asarray(getattr(other, name))
        lim = np.maximum(1e-10 * (1 + np.abs(w)), 10 * np.abs(w - o))
        d = np.abs(getattr(got, name).numpy() - w)
        assert (d <= lim).all(), f"{name} off by {d} against {lim}"
