"""Kernel 9 (erk4_sens; all six families, att, acc and att_tau under
sdf_cost) and kernel 1's acc / att_tau instantiations: the plain versions
against the JAX Pallas kernels (interpret mode, f32) and the JAX jacfwd path
(f64), and the wrappers' model dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t32, t64
from test_torch_families import _models

RNG = np.random.default_rng(37)


def _points(M, nx):
    """M random (x, u, dt): tilts within ~25 degrees (att_tau divides by
    cos(pitch)), body rates ~0.5, inputs inside the box."""
    x = RNG.normal(size=(M, nx)) * 0.5
    x[:, 3:7] = np.array([1.0, 0, 0, 0]) + RNG.normal(size=(M, 4)) * 0.2
    u = RNG.uniform(-0.9, 0.9, size=(M, 4))
    u[:, 0] = RNG.uniform(0.1, 0.9, size=M)
    return x, u, RNG.uniform(0.01, 0.1, size=M)


def _within(got, want, tol, name):
    """max |got - want| <= tol (1 + max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, lim = np.abs(got - want).max(), tol * (1 + np.abs(want).max())
    assert err <= lim, f"{name}: {err:.2e} > {lim:.2e}"


@pytest.mark.parametrize("model", ["rates", "wrench", "props", "att", "acc", "att_tau"])
def test_erk4_sens_plain_f32_matches_pallas_kernel_interpret(model):
    """The plain version (RK4 of f, torch.func.jacfwd) against the JAX
    kernel (RK4 of f_lanes, jax.linearize sweeps) in f32 on 37 points (not a
    lane multiple): x+ within 1e-5 and A, B within 1e-4 of (1 + their
    largest magnitude), the JAX package's own bounds (tests/test_ops.py)
    relative to scale, since props' B reaches ~14."""
    from sdf_nmpc_tpu.ops.lin_kernels import erk4_sens_lanes
    from sdf_nmpc_tpu_torch.ops.lin_kernels import erk4_sens

    jm, tm = _models(model)
    x, u, dt = (a.astype(np.float32) for a in _points(37, jm.nx))
    want = jax.jit(lambda *a: erk4_sens_lanes(jm.f_lanes, *a, interpret=True))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(dt))
    got = erk4_sens(tm, t32(x), t32(u), t32(dt))
    for name, g, w, tol in zip(("x+", "A", "B"), got, want, (1e-5, 1e-4, 1e-4)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _within(g.numpy(), w, tol, name)


@pytest.mark.parametrize("model", ["rates", "wrench", "props", "att", "acc", "att_tau"])
def test_erk4_sens_plain_f64_matches_jax_jacfwd_path(model):
    """f64 against vmap(erk4_with_sensitivities) on the JAX model's f, the
    JAX step's non-kernel path: the same algorithm, 1e-12."""
    from sdf_nmpc_tpu.solver.integrator import erk4_with_sensitivities
    from sdf_nmpc_tpu_torch.ops.lin_kernels import erk4_sens

    jm, tm = _models(model)
    x, u, dt = _points(24, jm.nx)
    want = jax.jit(jax.vmap(lambda a, b, c: erk4_with_sensitivities(jm.f, a, b, c)))(x, u, dt)
    got = erk4_sens(tm, t64(x), t64(u), t64(dt))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=1e-12)


def _lin_inputs(M, np_total, qd_idx):
    x, u, dt = _points(M, 10)
    p = np.zeros((M, np_total))
    qd = RNG.normal(size=(M, 4))
    p[:, list(qd_idx)] = qd / np.linalg.norm(qd, axis=1, keepdims=True)
    return x, u, dt, p, RNG.normal(size=(M, 11))


@pytest.mark.parametrize("model", ["acc", "att_tau"])
def test_lin_y_sens_plain_f32_matches_pallas_kernel_interpret(model):
    """Kernel 1's plain version for acc and att_tau against the JAX kernel
    in f32 on 37 points: x+ within 1e-5, A and B within 1e-4, the residual
    rows within 2e-4 of (1 + their largest magnitude).  att_tau's JAX kernel
    spells roll and pitch with polynomial atan2 / asin (up to ~3 and ~7 f32
    ulp), which the lag's 1 / TAU scales up in A."""
    from sdf_nmpc_tpu.ops.lin_kernels import erk4_y_sens_lanes
    from sdf_nmpc_tpu.params import ParamLayout
    from sdf_nmpc_tpu_torch.ops.lin_kernels import lin_y_sens
    from sdf_nmpc_tpu_torch.params import ParamLayout as TL
    from test_torch_families import family_configs

    jc, tc = family_configs(model)
    jm, tm = _models(model)
    jl, tl = ParamLayout.from_cfg(jc), TL.from_cfg(tc)
    x, u, dt, p, yref = (a.astype(np.float32) for a in _lin_inputs(37, jl.np_total, jl.q_d))
    kern = jax.jit(lambda *a: erk4_y_sens_lanes(jm.f_lanes, jm.y_lanes, *a, interpret=True))
    want = kern(jnp.asarray(x), jnp.asarray(u), jnp.asarray(dt),
                jnp.asarray(p[:, list(jl.q_d)]), jnp.asarray(yref))
    got = lin_y_sens(tm, tl, t32(x), t32(u), t32(dt), t32(p), t32(yref))
    tols = (1e-5, 1e-4, 1e-4, 2e-4, 2e-4, 2e-4)
    for name, g, w, tol in zip(("x+", "A", "B", "res", "Jyx", "Jyu"), got, want, tols):
        assert g.dtype == torch.float32
        _within(g.numpy(), w, tol, name)


@pytest.mark.parametrize("model", ["acc", "att_tau"])
def test_lin_y_sens_plain_f64_matches_jax_jacfwd_path(model):
    from sdf_nmpc_tpu.params import ParamLayout
    from sdf_nmpc_tpu.solver.integrator import erk4_with_sensitivities
    from sdf_nmpc_tpu_torch.ops.lin_kernels import lin_y_sens
    from sdf_nmpc_tpu_torch.params import ParamLayout as TL
    from test_torch_families import family_configs

    jc, tc = family_configs(model)
    jm, tm = _models(model)
    jl = ParamLayout.from_cfg(jc)
    x, u, dt, p, yref = _lin_inputs(24, jl.np_total, jl.q_d)

    def node(xv, uv, d, pv, yr):
        xn, A, B = erk4_with_sensitivities(jm.f, xv, uv, d)
        y_fn = lambda a, b: jm.y(a, b, pv)
        Jyx, Jyu = jax.jacfwd(y_fn, argnums=(0, 1))(xv, uv)
        return xn, A, B, y_fn(xv, uv) - yr, Jyx, Jyu

    want = jax.jit(jax.vmap(node))(x, u, dt, p, yref)
    got = lin_y_sens(tm, TL.from_cfg(tc), t64(x), t64(u), t64(dt), t64(p), t64(yref))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=1e-12)


def test_cuda_wrappers_refuse_models_without_an_instantiation():
    """Each kernel's CUDA path takes the instantiation named by the model's
    ``kernel_ids`` and raises for the others before it touches a tensor:
    kernel 1 serves att, acc and att_tau, kernel 9 all six families (att,
    acc and att_tau under sdf_cost), each with its own id."""
    from sdf_nmpc_tpu_torch.ops import lin_kernels

    x = torch.zeros(2, 10)
    for model in ("rates", "wrench", "props"):
        tm = _models(model)[1]
        with pytest.raises(NotImplementedError, match="lin_y_sens"):
            lin_kernels._lin_y_sens_cuda(tm, None, x, x, x, x, x)
    ids = {m: dict(_models(m)[1].kernel_ids)
           for m in ("att", "acc", "att_tau", "rates", "wrench", "props")}
    assert [ids[m].get("lin_y_sens") for m in ids] == [0, 1, 2, None, None, None]
    assert [ids[m]["erk4_sens"] for m in ids] == [3, 4, 5, 0, 1, 2]
