"""Port foundations against the JAX package: config, parameter layout, math,
the att model and the RK4 sensitivities (f64 unless stated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, t32, t64  # noqa: F401  (fixtures)

RNG = np.random.default_rng(21)


def _cfgs():
    from sdf_nmpc_tpu.config import default_config as jcfg
    from sdf_nmpc_tpu_torch.config import default_config as tcfg

    return jcfg(), tcfg()


def test_default_config_equals_jax_field_for_field():
    j, t = _cfgs()
    assert t.to_dict() == j.to_dict()
    assert t == t.replace()  # equality and hashing are by value
    assert hash(t) == hash(t.replace())


def test_load_config_equals_jax_load_config_field_for_field():
    """load_config of the JAX package's default.yaml: the JAX load_config's
    config field for field (the derived sensor extrinsics included), and the
    port's default_config."""
    from sdf_nmpc_tpu import default_config_dir
    from sdf_nmpc_tpu.config import load_config as jload
    from sdf_nmpc_tpu_torch.config import default_config, load_config

    path = default_config_dir() / "default.yaml"
    t = load_config(path)
    assert t.to_dict() == jload(path).to_dict()
    assert t == default_config()


def test_load_config_without_pyyaml_names_it(monkeypatch):
    """Where PyYAML does not import, load_config raises an ImportError that
    names PyYAML and make_config."""
    import builtins

    from sdf_nmpc_tpu import default_config_dir
    from sdf_nmpc_tpu_torch.config import load_config

    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(ImportError, match="PyYAML.*make_config"):
        load_config(default_config_dir() / "default.yaml")


def test_replace_semantics_match():
    j, t = _cfgs()
    upd = dict(solver=dict(qp_iters=12, dtype="float64"), nn=dict(size_latent=16))
    assert t.replace(**upd).to_dict() == j.replace(**upd).to_dict()
    with pytest.raises(AttributeError):
        t.solver = None


def test_param_layout_getters_match():
    from sdf_nmpc_tpu.params import ParamLayout as JL
    from sdf_nmpc_tpu_torch.params import ParamLayout as TL

    j, t = _cfgs()
    jl, tl = JL.from_cfg(j), TL.from_cfg(t)
    assert jl.np_total == tl.np_total
    p = RNG.normal(size=(5, jl.np_total))
    pt = t64(p)
    for name in ("get_flag", "get_W_p_Co", "get_W_R_Co", "get_q_d", "get_latent"):
        want = np.stack([np.asarray(getattr(jl, name)(jnp.asarray(row))) for row in p])
        np.testing.assert_array_equal(getattr(tl, name)(pt).numpy(), want, err_msg=name)
    # host setters write the same row-major layout
    pj, pp = np.zeros((3, jl.np_total)), np.zeros((3, jl.np_total))
    R = RNG.normal(size=(3, 3))
    for lay, arr in ((jl, pj), (tl, pp)):
        lay.set_flag(arr, 1.0)
        lay.set_camera(arr, [1.0, 2.0, 3.0], R)
        lay.set_q_d(arr, [1, 0, 0, 0])
        lay.set_latent(arr, np.arange(lay.size_latent))
    np.testing.assert_array_equal(pj, pp)


def test_math_matches_f64():
    from sdf_nmpc_tpu import math as jm
    from sdf_nmpc_tpu_torch import math as tm

    q = RNG.normal(size=(6, 4))
    q2 = RNG.normal(size=(6, 4))
    e = RNG.normal(size=(6, 3))
    yaw = RNG.normal(size=6)
    cases = [
        ("quat2rot", (q,)), ("euler2rot", (e,)), ("hamilton_prod", (q, q2)),
        ("quat_invert", (q,)), ("quat2yaw", (q,)), ("yaw2quat", (yaw,)),
    ]
    for name, args in cases:
        got = getattr(tm, name)(*[t64(a) for a in args]).numpy()
        want = np.stack([np.asarray(getattr(jm, name)(*[jnp.asarray(a[i]) for a in args]))
                         for i in range(6)])
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14, err_msg=name)


def _models():
    from sdf_nmpc_tpu.models import make_model as jmake
    from sdf_nmpc_tpu_torch.models import make_model as tmake

    j, t = _cfgs()
    return jmake(j), tmake(t)


def _xu(n):
    x = RNG.normal(size=(n, 10))
    x[:, 3:7] += np.array([1.5, 0, 0, 0])
    u = RNG.uniform(-0.9, 0.9, size=(n, 4))
    u[:, 0] = RNG.uniform(0.1, 0.9, size=n)
    return x, u


def test_att_model_f_y_yN_match_f64():
    jm, tm = _models()
    x, u = _xu(16)
    from sdf_nmpc_tpu.params import ParamLayout

    lay = ParamLayout.from_cfg(_cfgs()[0])
    p = np.zeros((16, lay.np_total))
    qd = RNG.normal(size=(16, 4))
    p[:, list(lay.q_d)] = qd / np.linalg.norm(qd, axis=1, keepdims=True)
    p[:, lay.flag] = 1.0
    want_f = np.asarray(jax.vmap(jm.f)(jnp.asarray(x), jnp.asarray(u)))
    want_y = np.asarray(jax.vmap(jm.y)(jnp.asarray(x), jnp.asarray(u), jnp.asarray(p)))
    want_yN = np.asarray(jax.vmap(jm.yN)(jnp.asarray(x), jnp.asarray(p)))
    np.testing.assert_allclose(tm.f(t64(x), t64(u)).numpy(), want_f, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tm.y(t64(x), t64(u), t64(p)).numpy(), want_y, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(tm.yN(t64(x), t64(p)).numpy(), want_yN, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tm.u_to_TRPYr(t64(x), t64(u), t64(p)).numpy(),
                               np.asarray(jax.vmap(jm.u_to_TRPYr)(x, u, p)), rtol=1e-14)
    for name in ("u_hover", "lbu", "ubu"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    assert (tm.nx, tm.nu, tm.ny, tm.nyN) == (jm.nx, jm.nu, jm.ny, jm.nyN)


def test_att_lanes_forms_match_jax_lanes_f32():
    """The kernel's arithmetic (f_lanes / y_lanes) equals the JAX lanes forms.
    f32: same operations in the same order, but sin/cos/rsqrt come from two
    libraries and differ by a few ulp (values up to ~10), hence 1e-5."""
    jm, tm = _models()
    x, u = _xu(32)
    x, u = x.astype(np.float32), u.astype(np.float32)
    qd = RNG.normal(size=(32, 4)).astype(np.float32)
    want_f = np.asarray(jm.f_lanes(jnp.asarray(x.T), jnp.asarray(u.T))).T
    want_y = np.asarray(jm.y_lanes(jnp.asarray(x.T), jnp.asarray(u.T), jnp.asarray(qd.T))).T
    np.testing.assert_allclose(tm.f_lanes(t32(x), t32(u)).numpy(), want_f, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tm.y_lanes(t32(x), t32(u), t32(qd)).numpy(), want_y,
                               rtol=1e-5, atol=1e-5)
    # and the lanes forms agree with f / y (the algebraic cos/sin-of-atan2 is exact)
    p = np.zeros((32, 145), np.float32)
    p[:, 13:17] = qd
    np.testing.assert_allclose(tm.f_lanes(t32(x), t32(u)).numpy(),
                               tm.f(t32(x), t32(u)).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.y_lanes(t32(x), t32(u), t32(qd)).numpy(),
                               tm.y(t32(x), t32(u), t32(p)).numpy(), rtol=1e-5, atol=1e-5)


def test_erk4_with_sensitivities_matches_f64():
    from sdf_nmpc_tpu.solver.integrator import erk4_with_sensitivities as jsens
    from sdf_nmpc_tpu_torch.solver.integrator import erk4_with_sensitivities as tsens

    jm, tm = _models()
    x, u = _xu(8)
    dt = RNG.uniform(0.01, 0.1, size=8)
    want = jax.vmap(lambda a, b, c: jsens(jm.f, a, b, c))(x, u, dt)
    got = torch.func.vmap(lambda a, b, c: tsens(tm.f, a, b, c))(t64(x), t64(u), t64(dt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def test_model_registry():
    """All six quad families build, with the JAX package's dims and names;
    an unknown key raises and names the families."""
    from sdf_nmpc_tpu.models import make_model as jmake
    from sdf_nmpc_tpu_torch.models import make_model

    j, t = _cfgs()
    for key in ("att", "acc", "att_tau", "rates", "wrench", "props"):
        jm = jmake(j.replace(mpc=dict(model=key)))
        tm = make_model(t.replace(mpc=dict(model=key)))
        assert (tm.name, tm.nx, tm.nu, tm.ny, tm.nyN) == (jm.name, jm.nx, jm.nu, jm.ny, jm.nyN)
    with pytest.raises(ValueError, match="props"):
        make_model(t.replace(mpc=dict(model="nope")))


def test_ref_pack_and_shooting_grid_match():
    from sdf_nmpc_tpu.ocp import shooting_nodes as jnodes
    from sdf_nmpc_tpu.ref_gen import Ref as JRef
    from sdf_nmpc_tpu_torch.ocp import shooting_nodes as tnodes
    from sdf_nmpc_tpu_torch.ref_gen import Ref as TRef

    j, t = _cfgs()
    jm, tm = _models()
    for constrained in (False, True):
        rj, rt = JRef(j).use_constrained_weights(constrained), TRef(t).use_constrained_weights(
            constrained)
        rj.p = rt.p = np.array([1.0, -2.0, 0.5])
        rj.v = rt.v = np.array([0.1, 0.2, 0.3])
        for a, b in zip(jm.formate_ref(rj), tm.formate_ref(rt)):
            np.testing.assert_array_equal(a, b)
    for uniform in (True, False):
        kw = dict(mpc=dict(uniform_dt=uniform))
        np.testing.assert_array_equal(jnodes(j.replace(**kw)), tnodes(t.replace(**kw)))
