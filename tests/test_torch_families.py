"""The five quad families beside ``att`` against the JAX package's models:
math helpers, f / y / yN / command maps / reference packing / bounds in f64,
and the component forms the CUDA kernels run (f_lanes, y_lanes) in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, t32, t64  # noqa: F401  (fixtures)

RNG = np.random.default_rng(31)
FAMILIES = ("acc", "att_tau", "rates", "wrench", "props")


def family_configs(model, **upd):
    """(JAX config, port config) of a family; wrench with the representative
    torque limit 2.0 of the JAX accuracy workload (the shipped 0 zeroes its
    torque inputs)."""
    from sdf_nmpc_tpu.config import default_config as jcfg
    from sdf_nmpc_tpu_torch.config import default_config as tcfg

    upd = dict(upd, mpc=dict(upd.get("mpc", {}), model=model))
    if model == "wrench":
        upd["robot"] = dict(limits=dict(torques=2.0))
    return jcfg().replace(**upd), tcfg().replace(**upd)


def _models(model):
    from sdf_nmpc_tpu.models import make_model as jmake
    from sdf_nmpc_tpu_torch.models import make_model as tmake

    j, t = family_configs(model)
    return jmake(j), tmake(t)


def family_points(nx, n):
    """n random (x, u) rows: unnormalized quaternions near identity, body
    rates (nx=13) of magnitude ~0.5, inputs inside the box."""
    x = RNG.normal(size=(n, nx)) * 0.5
    x[:, 3:7] += np.array([1.2, 0, 0, 0])
    u = RNG.uniform(-0.9, 0.9, size=(n, 4))
    u[:, 0] = RNG.uniform(0.1, 0.9, size=n)
    return x, u


def _params(n):
    from sdf_nmpc_tpu.params import ParamLayout

    lay = ParamLayout.from_cfg(family_configs("att")[0])
    p = np.zeros((n, lay.np_total))
    qd = RNG.normal(size=(n, 4))
    p[:, list(lay.q_d)] = qd / np.linalg.norm(qd, axis=1, keepdims=True)
    p[:, lay.flag] = 1.0
    return p, lay


def test_math_additions_match_f64():
    from sdf_nmpc_tpu import math as jm
    from sdf_nmpc_tpu.models import base as jb
    from sdf_nmpc_tpu_torch import math as tm
    from sdf_nmpc_tpu_torch.models import base as tb

    q = RNG.normal(size=(7, 4))
    e = RNG.normal(size=(7, 3)) * 0.6
    for name, a in (("quat2euler", q), ("deuler_avel_map", e)):
        want = np.stack([np.asarray(getattr(jm, name)(jnp.asarray(r))) for r in a])
        np.testing.assert_allclose(getattr(tm, name)(t64(a)).numpy(), want, rtol=1e-13,
                                   atol=1e-14, err_msg=name)
    for axis in "xyz":
        np.testing.assert_array_equal(tm.axis_rot(axis, 0.3), jm.axis_rot(axis, 0.3))
    with pytest.raises(ValueError):
        tm.axis_rot("w", 0.3)
    R = [jm.axis_rot("z", 0.4 * i) @ jm.axis_rot("x", 0.1 * i) for i in range(4)]
    pos, signs = RNG.normal(size=(4, 3)), [1, -1, 1, -1]
    for g, w in zip(tm.gtmrp_matrix(R, pos, signs, [0.02] * 4, [2e-4] * 4),
                    jm.gtmrp_matrix(R, pos, signs, [0.02] * 4, [2e-4] * 4)):
        np.testing.assert_array_equal(g, w)
    # the component helpers, (k, L) in JAX against (..., k) here
    qj, Rj = jb.lanes_quat(jnp.asarray(q.T))
    qt, Rt = tb.lanes_quat(t64(q))
    np.testing.assert_allclose(np.stack([c.numpy() for c in qt]), np.stack(qj), rtol=1e-14)
    np.testing.assert_allclose(np.array([[c.numpy() for c in r] for r in Rt]),
                               np.array([[np.asarray(c) for c in r] for r in Rj]), rtol=1e-13,
                               atol=1e-14)
    v = RNG.normal(size=(3, 7))
    for name in ("lanes_mv3", "lanes_mv3t"):
        want = getattr(jb, name)(Rj, list(jnp.asarray(v)))
        got = getattr(tb, name)(Rt, [t64(r) for r in v])
        np.testing.assert_allclose(np.stack([c.numpy() for c in got]), np.stack(want),
                                   rtol=1e-13, atol=1e-14, err_msg=name)
    got = tb.lanes_quat_deriv(qt, [t64(r) for r in v])
    np.testing.assert_allclose(np.stack([c.numpy() for c in got]),
                               np.stack(jb.lanes_quat_deriv(qj, list(jnp.asarray(v)))),
                               rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("model", FAMILIES)
def test_family_matches_jax_f64(model):
    """Dims, bounds, hover input, f, y, yN, the command maps the family has,
    the world velocity and the reference packing, against the JAX model."""
    from sdf_nmpc_tpu.ref_gen import Ref as JRef
    from sdf_nmpc_tpu_torch.ref_gen import Ref as TRef

    jm, tm = _models(model)
    assert (tm.name, tm.nx, tm.nu, tm.ny, tm.nyN) == (jm.name, jm.nx, jm.nu, jm.ny, jm.nyN)
    for name in ("u_hover", "lbu", "ubu"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    n = 12
    x, u = family_points(jm.nx, n)
    p, _ = _params(n)
    X, U, P = jnp.asarray(x), jnp.asarray(u), jnp.asarray(p)
    checks = [("f", tm.f(t64(x), t64(u)), jax.vmap(jm.f)(X, U)),
              ("y", tm.y(t64(x), t64(u), t64(p)), jax.vmap(jm.y)(X, U, P)),
              ("yN", tm.yN(t64(x), t64(p)), jax.vmap(jm.yN)(X, P)),
              ("vel_world", tm.vel_world(t64(x)), jax.vmap(jm.vel_world)(X))]
    for name in ("u_to_acc", "u_to_TRPYr", "u_to_props", "u_to_cmd"):
        assert (getattr(tm, name) is None) == (getattr(jm, name) is None), name
        if getattr(jm, name) is not None:
            checks.append((name, getattr(tm, name)(t64(x), t64(u), t64(p)),
                           jax.vmap(getattr(jm, name))(X, U, P)))
    for name, got, want in checks:
        assert got.dtype == torch.float64, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    jc, tc = family_configs(model)
    for constrained in (False, True):
        rj, rt = JRef(jc).use_constrained_weights(constrained), TRef(tc).use_constrained_weights(
            constrained)
        rj.p = rt.p = np.array([1.0, -2.0, 0.5])
        rj.v = rt.v = np.array([0.1, 0.2, 0.3])
        rj.wz = rt.wz = 0.4
        for n_extra in (0, 2):
            for a, b in zip(jm.formate_ref(rj, n_extra), tm.formate_ref(rt, n_extra)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", FAMILIES)
def test_family_lanes_forms_match_jax_f32(model):
    """f_lanes (and y_lanes where the family has it) against the JAX
    component forms in f32, within 1e-5 relative and 1e-5 (1 + max |f|)
    absolute, and against the port's own f / y.  att_tau's JAX form spells
    roll and pitch with polynomial atan2 / asin (up to ~3 and ~7 f32 ulp);
    the port's uses the true functions: the printed distance is that
    difference through the lag's 1 / TAU."""
    jm, tm = _models(model)
    assert (tm.y_lanes is None) == (jm.y_lanes is None)
    x, u = (a.astype(np.float32) for a in family_points(jm.nx, 64))
    p, lay = _params(64)
    p = p.astype(np.float32)
    qd = p[:, list(lay.q_d)]
    got = tm.f_lanes(t32(x), t32(u))
    want = np.asarray(jm.f_lanes(jnp.asarray(x.T), jnp.asarray(u.T))).T
    scale = 1 + np.abs(want).max()
    print(f"{model}: f_lanes port vs JAX, f32: max {np.abs(got.numpy() - want).max():.2e} "
          f"(largest |f| {scale - 1:.2f})")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), tm.f(t32(x), t32(u)).numpy(), rtol=1e-5,
                               atol=1e-5 * scale)
    if jm.y_lanes is not None:
        got = tm.y_lanes(t32(x), t32(u), t32(qd))
        want = np.asarray(jm.y_lanes(jnp.asarray(x.T), jnp.asarray(u.T), jnp.asarray(qd.T))).T
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), tm.y(t32(x), t32(u), t32(p)).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ("att",) + FAMILIES)
def test_kernel_constants(model):
    """The kernels' constant block: the four input scales, then (props) the
    mass, Gf, Gt and the inertia diagonals, each rounded to f32."""
    from sdf_nmpc_tpu_torch.models.base import N_KERNEL_CONSTS

    jc, tc = family_configs(model)
    tm = _models(model)[1]
    c = np.asarray(tm.kernel_consts)
    assert c.shape == (N_KERNEL_CONSTS,) and c.dtype == np.float64
    np.testing.assert_array_equal(c, c.astype(np.float32))
    lim = tc.robot.limits
    scales = {"att": (lim.gamma, lim.roll, lim.pitch, lim.wz),
              "acc": (lim.ax, lim.ay, lim.az, lim.wz),
              "att_tau": (lim.gamma, lim.roll, lim.pitch, lim.wz),
              "rates": (lim.gamma, lim.wx, lim.wy, lim.wz), "wrench": (lim.gamma,) + (2.0,) * 3,
              "props": (lim.wp,) * 4}
    np.testing.assert_array_equal(c[:4], np.float32(scales[model]))
    if model != "props":
        assert not c[4:].any()
        return
    from sdf_nmpc_tpu.models.quad_props import _allocation_from_cfg

    Gf, Gt = _allocation_from_cfg(jc)
    J = np.asarray(tc.robot.inertia)
    np.testing.assert_array_equal(
        c[4:], np.float32(np.concatenate([[tc.robot.mass], Gf.ravel(), Gt.ravel(), J, 1 / J])))


def test_model_registry_lists_six_families():
    from sdf_nmpc_tpu.models import available_models as javail
    from sdf_nmpc_tpu_torch.models import available_models

    assert available_models() == javail() == sorted(("att",) + FAMILIES)
