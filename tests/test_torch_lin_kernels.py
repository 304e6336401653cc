"""Kernel 1 (lin_y_sens): the plain version against the JAX Pallas kernel
(interpret mode, f32) and the JAX jacfwd path (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import one_torch_thread, t32, t64  # noqa: F401  (fixtures)

RNG = np.random.default_rng(13)


def _setup():
    from sdf_nmpc_tpu.config import default_config as jcfg
    from sdf_nmpc_tpu.models import make_model as jmake
    from sdf_nmpc_tpu.params import ParamLayout as JL
    from sdf_nmpc_tpu_torch.config import default_config as tcfg
    from sdf_nmpc_tpu_torch.models import make_model as tmake
    from sdf_nmpc_tpu_torch.params import ParamLayout as TL

    return jmake(jcfg()), JL.from_cfg(jcfg()), tmake(tcfg()), TL.from_cfg(tcfg())


def _inputs(M, np_total, qd_idx):
    x = RNG.normal(size=(M, 10))
    x[:, 3:7] += np.array([1.5, 0, 0, 0])
    u = RNG.uniform(-0.9, 0.9, size=(M, 4))
    u[:, 0] = RNG.uniform(0.1, 0.9, size=M)
    dt = RNG.uniform(0.01, 0.1, size=M)
    p = np.zeros((M, np_total))
    qd = RNG.normal(size=(M, 4))
    p[:, list(qd_idx)] = qd / np.linalg.norm(qd, axis=1, keepdims=True)
    yref = RNG.normal(size=(M, 11))
    return x, u, dt, p, yref


def test_plain_f32_matches_pallas_kernel_interpret():
    """Tolerances of the JAX package's own kernel tests (tests/test_ops.py):
    x+ 1e-5, A/B 1e-4, residual rows 2e-4 + 1e-4 rel.  The Pallas kernel runs
    the algebraic cos/sin-of-atan2 form, the plain version true atan2."""
    from sdf_nmpc_tpu.ops.lin_kernels import erk4_y_sens_lanes
    from sdf_nmpc_tpu_torch.ops.lin_kernels import lin_y_sens

    jm, jl, tm, tl = _setup()
    M = 37  # not a multiple of the TPU lane count
    x, u, dt, p, yref = (a.astype(np.float32) for a in _inputs(M, jl.np_total, jl.q_d))
    kern = jax.jit(lambda *a: erk4_y_sens_lanes(jm.f_lanes, jm.y_lanes, *a, interpret=True))
    want = kern(jnp.asarray(x), jnp.asarray(u), jnp.asarray(dt),
                jnp.asarray(p[:, list(jl.q_d)]), jnp.asarray(yref))
    got = lin_y_sens(tm, tl, t32(x), t32(u), t32(dt), t32(p), t32(yref))
    tols = [(1e-5, 1e-5), (1e-4, 0), (1e-4, 0), (2e-4, 1e-4), (2e-4, 1e-4), (2e-4, 1e-4)]
    for name, g, w, (atol, rtol) in zip(("x+", "A", "B", "res", "Jyx", "Jyu"), got, want, tols):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=name)


def test_plain_f64_matches_jax_jacfwd_path():
    """f64 against erk4_with_sensitivities + jacfwd of y: the same algorithm,
    so only summation order separates them (1e-12)."""
    from sdf_nmpc_tpu.solver.integrator import erk4_with_sensitivities
    from sdf_nmpc_tpu_torch.ops.lin_kernels import lin_y_sens

    jm, jl, tm, tl = _setup()
    x, u, dt, p, yref = _inputs(24, jl.np_total, jl.q_d)

    def node(xv, uv, d, pv, yr):
        xn, A, B = erk4_with_sensitivities(jm.f, xv, uv, d)
        y_fn = lambda a, b: jm.y(a, b, pv)
        Jyx, Jyu = jax.jacfwd(y_fn, argnums=(0, 1))(xv, uv)
        return xn, A, B, y_fn(xv, uv) - yr, Jyx, Jyu

    want = jax.jit(jax.vmap(node))(x, u, dt, p, yref)
    got = lin_y_sens(tm, tl, t64(x), t64(u), t64(dt), t64(p), t64(yref))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=1e-12)

