"""The offline theory tooling of the port against the JAX package's: the
3-variate polynomial, the stability constant r-tilde, the braking-distance
analysis and its surrogates, and the generic Mlp.  f64 on the CPU (the JAX
side under the x64 of tests/conftest.py); the MLP fits in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, t64  # noqa: F401  (fixtures)

RNG = np.random.default_rng(41)


def _configs():
    from sdf_nmpc_tpu.config import default_config as jcfg
    from sdf_nmpc_tpu_torch.config import default_config as tcfg

    return jcfg(), tcfg()


@pytest.mark.parametrize("deg", [2, 4])
def test_polynomial_3variate_matches_jax(deg):
    """The term order (the coefficient layout), the value and the Jacobian
    on seeded points with negative coordinates, to 1e-12."""
    from sdf_nmpc_tpu import math as jm
    from sdf_nmpc_tpu_torch import math as tm

    np.testing.assert_array_equal(tm.polynomial_3variate_exponents(deg),
                                  jm.polynomial_3variate_exponents(deg))
    n = tm.polynomial_3variate_exponents(deg).shape[0]
    c = RNG.normal(size=n)
    x = RNG.normal(size=(17, 3)) * 1.5
    jfn, _ = jm.polynomial_3variate(deg, c)
    tfn, _ = tm.polynomial_3variate(deg, c)
    np.testing.assert_allclose(tfn(t64(x)).numpy(), np.asarray(jax.vmap(jfn)(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    tjac = torch.func.vmap(torch.func.jacfwd(tfn))(t64(x)).numpy()
    np.testing.assert_allclose(tjac, np.asarray(jax.vmap(jax.jacfwd(jfn))(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    # the unbound form takes the coefficients per call
    tfree, _ = tm.polynomial_3variate(deg)
    np.testing.assert_array_equal(tfree(t64(x), c).numpy(), tfn(t64(x)).numpy())


def test_r_tilde_value_and_max_match_jax():
    """r_tilde on seeded points of the thrust / attitude box, and its
    maximum (the 96^3 grid, then 200 projected ascent steps), to 1e-9
    relative."""
    from sdf_nmpc_tpu.theory import stability as js
    from sdf_nmpc_tpu_torch.theory import stability as ts

    jc, tc = _configs()
    kw = dict(g=9.81, dt=0.05, r1=2.0, r2=3.0, r3=5.0)
    T, phi, theta = RNG.uniform(0, 20, 50), RNG.uniform(-0.6, 0.6, 50), RNG.uniform(-0.6, 0.6, 50)
    want = np.asarray(js.r_tilde_value(jnp.asarray(T), jnp.asarray(phi), jnp.asarray(theta), **kw))
    got = ts.r_tilde_value(t64(T), t64(phi), t64(theta), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    want_max = js.get_r_tilde_max(jc)
    got_max = ts.get_r_tilde_max(tc, device="cpu")
    assert abs(got_max - want_max) <= 1e-9 * abs(want_max), (got_max, want_max)


def test_max_braking_accel_matches_jax():
    """The vectorized 60-step bisection on 200 seeded directions, to 1e-12."""
    from sdf_nmpc_tpu.theory import braking as jb
    from sdf_nmpc_tpu_torch.theory import braking as tb

    jc, tc = _configs()
    v = RNG.normal(size=(200, 3))
    want = jb.max_braking_accel(v, jc)
    got = tb.max_braking_accel(v, tc, device="cpu")
    assert got.shape == (200,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_braking_grid_fit_poly_and_surrogate_match_jax():
    """braking_grid at vmax=1, step=0.5: the same velocities, braking
    distances and decelerations; min_braking_accel, fit_poly (degree 4 and
    2) and eval_surrogate of the fitted polynomial, to 1e-10."""
    from sdf_nmpc_tpu import math as jm
    from sdf_nmpc_tpu.theory import braking as jb
    from sdf_nmpc_tpu_torch import math as tm
    from sdf_nmpc_tpu_torch.theory import braking as tb

    jc, tc = _configs()
    jv, jd, ja = jb.braking_grid(jc, vmax=1.0, step=0.5)
    tv, td, ta = tb.braking_grid(tc, vmax=1.0, step=0.5, device="cpu")
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ta, ja, rtol=1e-10, atol=1e-10)
    assert abs(tb.min_braking_accel(tv, td) - jb.min_braking_accel(jv, jd)) <= 1e-10
    for deg in (4, 2):
        jcoef, tcoef = jb.fit_poly(jv, jd, deg), tb.fit_poly(tv, td, deg)
        np.testing.assert_allclose(tcoef, jcoef, rtol=1e-10, atol=1e-10)
        want = jb.eval_surrogate(jm.polynomial_3variate(deg, jcoef)[0], jv, jd)
        got = tb.eval_surrogate(tm.polynomial_3variate(deg, tcoef)[0], tv, td)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_mlp_forward_matches_flax_with_carried_params():
    """The port's Mlp with a flax Mlp's parameters carried across
    (mlp_params_from_flax), tanh inner and sigmoid output activations, f64,
    to 1e-12; dropout is off at eval."""
    from sdf_nmpc_tpu.nn.mlp import Mlp as JMlp
    from sdf_nmpc_tpu_torch.nn import Mlp, mlp_params_from_flax

    jm = JMlp(size_out=2, layer_sizes=[8, 16, 8], inner_act=jnp.tanh, out_act=jax.nn.sigmoid,
              dropout_rate=0.3)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros(3))
    x = RNG.normal(size=(23, 3))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = Mlp(3, 2, (8, 16, 8), inner_act=torch.tanh, out_act=torch.sigmoid, dropout_rate=0.3)
    tm.load_state_dict(mlp_params_from_flax(jax.tree.map(np.asarray, params)))
    tm = tm.double().eval()
    with torch.no_grad():
        got = tm(t64(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_fit_mlp_loss_falls_and_tracks_jax():
    """fit_mlp on a braking grid (vmax=1.5, step=0.25): the grid loss of the
    fitted surrogate is below the initial one and within 10% of the JAX
    fit's after the same epochs (the same numpy batch order; the initial
    weights come from different generators)."""
    from sdf_nmpc_tpu.theory import braking as jb
    from sdf_nmpc_tpu_torch.nn import Mlp
    from sdf_nmpc_tpu_torch.theory import braking as tb

    jc, tc = _configs()
    vel, bd, _ = tb.braking_grid(tc, vmax=1.5, step=0.25, device="cpu")
    kw = dict(layer_sizes=(16, 16), epochs=40, batch_size=64, lr=3e-3, seed=0)
    module, last = tb.fit_mlp(vel, bd, device="cpu", **kw)
    jmod, jparams, jlast = jb.fit_mlp(vel, bd, **kw)
    x, y = torch.as_tensor(vel, dtype=torch.float32), bd.astype(np.float32)
    with torch.no_grad():
        loss = float(np.mean((module(x).numpy()[:, 0] - y) ** 2))
        fresh = Mlp(3, 1, kw["layer_sizes"], inner_act=torch.tanh,
                    generator=torch.Generator().manual_seed(0))
        loss0 = float(np.mean((fresh(x).numpy()[:, 0] - y) ** 2))
    jloss = float(np.mean((np.asarray(jmod.apply(jparams, jnp.asarray(vel, jnp.float32)))[:, 0]
                           - y) ** 2))
    assert np.isfinite(last) and loss < 0.5 * loss0, (loss, loss0)
    assert abs(loss - jloss) <= 0.1 * jloss, (loss, jloss)
