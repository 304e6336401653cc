"""The solver knobs of the JAX package that route around the kernels or
perturb the QP's numerics: ``lin_impl: xla``, ``qp_data_bf16`` and
``qp_compute_dtype``, each against the JAX package on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, one_torch_thread, port_net  # noqa: F401  (fixtures)
from test_torch_family_step import step_inputs
from test_torch_ip_kernel import _qp
from test_torch_riccati import L, _ocps, _scenarios


def _port_step(model, B=3, **solver):
    """(port ocp, cfg, SolveInputs, initial state) on the narrow net, f64."""
    from sdf_nmpc_tpu_torch.solver import SolveInputs, init_state

    jc, jocp, tc, tocp = _ocps(model, 20, dtype="float64", **solver)
    x0, p, yr, W = _scenarios(jc, jocp, B, seed=31)
    inp = step_inputs(SolveInputs, lambda a: torch.as_tensor(np.array(a), dtype=torch.float64),
                      x0, p, yr, W, 20, tocp.nyN)
    return tocp, tc, inp, init_state(tocp, inp.x0, torch.float64), (jc, jocp, x0, p, yr, W)


@pytest.mark.parametrize("model", ["att", "props"])
def test_lin_impl_xla_gives_the_auto_step_on_the_cpu(model, monkeypatch):
    """lin_impl 'xla' linearizes by torch.func through RK4 and condenses by
    the plain recursion, calling none of the wrappers of kernels 1, 9 and 3
    (on the card: none launched).  On the CPU 'auto' runs those wrappers'
    plain versions, the same functions: u0, X, U and the KKT residual equal
    to 1e-12 (att's kernel-1 plain version differentiates the model's
    residual alone, the xla route the OCP's, the same function here)."""
    from sdf_nmpc_tpu_torch.ops import condense_kernel, lin_kernels
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    ocp, cfg, inp, st, _ = _port_step(model)
    want = make_rti_step(ocp, cfg, with_evals=False)(st, inp)

    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"lin_impl xla called {name}")
        return f

    for mod, name in ((lin_kernels, "lin_y_sens"), (lin_kernels, "erk4_sens"),
                      (condense_kernel, "condense")):
        monkeypatch.setattr(mod, name, refuse(name))
    got = make_rti_step(ocp, cfg.replace(solver=dict(lin_impl="xla")), with_evals=False)(st, inp)
    assert (got.status == 0).all() and (want.status == 0).all()
    for name, g, w in (("u0", got.u0, want.u0), ("X", got.state.X, want.state.X),
                       ("U", got.state.U, want.state.U),
                       ("kkt", got.kkt_residual, want.kkt_residual)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12, rtol=0, err_msg=name)


def test_qp_data_bf16_rounds_as_jax_and_the_step_matches_jax(monkeypatch):
    """qp_data_bf16 rounds H and C to bf16 (to nearest, ties to even) and
    back: the port's rounding of the step's own H and C equals JAX's
    astype(bfloat16) bit for bit, ties included.  Then the f64 cold step
    (att, narrow net, B 3) against the JAX step with the same knob: u0, X
    and U at 1e-9 (the two f64 H lie ~1e-16 apart, far from a bf16 rounding
    boundary; the QPs are then the same)."""
    from sdf_nmpc_tpu.solver import SolveInputs as JInputs
    from sdf_nmpc_tpu.solver import init_state as jinit
    from sdf_nmpc_tpu.solver import make_rti_step as jmake
    from sdf_nmpc_tpu_torch.solver import make_rti_step, sqp

    ocp, cfg, inp, st, (jc, jocp, x0, p, yr, W) = _port_step("att", qp_data_bf16=True)
    seen = []
    orig = sqp.solve_qp
    monkeypatch.setattr(sqp, "solve_qp", lambda qp, **kw: seen.append(qp) or orig(qp, **kw))
    got = make_rti_step(ocp, cfg, with_evals=False)(st, inp)
    make_rti_step(ocp, cfg.replace(solver=dict(qp_data_bf16=False)), with_evals=False)(st, inp)
    (rounded, exact) = seen
    ties = torch.tensor([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8), 1e-3, 3.0e38],
                        dtype=torch.float64)
    for name, r, x in (("H", rounded.H, exact.H), ("C", rounded.C, exact.C),
                       ("ties", sqp.bf16_round(ties), ties)):
        want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.bfloat16).astype(jnp.float64))
        np.testing.assert_array_equal(r.numpy().view(np.uint64), want.view(np.uint64),
                                      err_msg=name)
    assert not torch.equal(rounded.H, exact.H)

    jT = lambda a: jnp.asarray(a, jnp.float64)
    jres = jax.jit(jax.vmap(jmake(jocp, jc.replace(solver=dict(qp_data_bf16=True)),
                                  with_evals=False)))(
        jax.vmap(lambda x: jinit(jocp, x, jnp.float64))(jnp.asarray(x0)),
        step_inputs(JInputs, jT, x0, p, yr, W, 20, jocp.nyN))
    assert (np.asarray(jres.status) == 0).all() and (got.status == 0).all()
    for name, g, w in (("u0", got.u0, jres.u0), ("X", got.state.X, jres.state.X),
                       ("U", got.state.U, jres.state.U)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9, rtol=0, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_compute_dtype(data_dtype, compute_dtype):
    """The JAX solve_qp(compute_dtype=...) on both of its routes."""
    from sdf_nmpc_tpu.solver.qp import QpData as JQ
    from sdf_nmpc_tpu.solver.qp import solve_qp as jsolve

    q = {k: v.astype(data_dtype) for k, v in _qp(4, 16, 10, seed=7).items()}
    jq = JQ(**{k: jnp.asarray(v) for k, v in q.items()})
    return q, {impl: jax.jit(jax.vmap(lambda qq: jsolve(
        qq, chol_impl=impl, compute_dtype=jnp.dtype(compute_dtype), k_stiff=8, **QP_KW)))(jq)
        for impl in ("xla", "custom")}


QP_KW = dict(iters=14, stiff_iters=6, mu0=0.1, box_margin=1e-6, ir_steps=0)


@pytest.mark.parametrize("data_dtype", ["float64", "float32"])
@pytest.mark.parametrize("chol_impl", ["auto", "xla", "custom"])
def test_qp_compute_dtype_matches_jax_solve_qp(data_dtype, chol_impl):
    """solve_qp(compute_dtype=float64): the IP arithmetic in f64, the
    factorizations and solves in the data's dtype, on the composed path
    ('auto' takes kernels 5-8's route, their plain versions on the CPU;
    JAX's 'auto' on the CPU is its 'xla'), against the JAX solve_qp on the
    same route (nz 16, nc 10, 8 + 6 iterations).  f64 data: dz at 1e-10.
    f32 data: the f32 factorizations round differently on the two sides
    (LAPACK against XLA), and this QP family (penalties 1e3 / 1e4) carries
    that to dz as the JAX package's own two routes differ from each other,
    so dz is held within 2 x that spread.  The result is in the compute
    dtype, as in JAX."""
    from sdf_nmpc_tpu_torch.solver.qp import QpData as TQ
    from sdf_nmpc_tpu_torch.solver.qp import solve_qp as tsolve

    q, out = _jax_compute_dtype(data_dtype, "float64")
    want = out["xla" if chol_impl == "auto" else chol_impl]
    got = tsolve(TQ(**{k: torch.as_tensor(v) for k, v in q.items()}), chol_impl=chol_impl,
                 compute_dtype=torch.float64, k_stiff=8, **QP_KW)
    assert got.dz.dtype == torch.float64
    spread = float(np.abs(np.asarray(out["xla"].dz) - np.asarray(out["custom"].dz)).max())
    tol = 1e-10 if data_dtype == "float64" else 2 * spread
    np.testing.assert_allclose(got.dz.numpy(), np.asarray(want.dz), atol=tol, rtol=0)
