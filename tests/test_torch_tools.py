"""The port's flagship workload builder and tools against the JAX
package's: ``entry.build`` against ``__graft_entry__._build``, the
``find_rtilde`` and ``find_amax`` CLIs against the JAX scripts on the same
arguments (and each package's surrogate file read by the other),
``resolution_shift`` against the same computation built from the JAX
package, chained e2e ticks against the JAX tick, the e2e run's control flow,
and the trained decoder against flax.  f64 on the CPU unless named."""

import json
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, one_torch_thread, port_net  # noqa: F401  (fixtures)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
L, LAYERS = 8, (16, 16, 16, 16)  # the dry run's network: latent 8, 4 x 16
SENSOR = dict(shape_imgs=(1, 36, 64))  # a small image the ResNet encoder takes


@pytest.fixture
def no_xla_cache(monkeypatch):
    """The JAX builder turns on JAX's persistent compilation cache under the
    user's cache directory: not from a test."""
    from sdf_nmpc_tpu.utils import xla_cache

    monkeypatch.setattr(xla_cache, "enable_persistent_cache", lambda: None)
    monkeypatch.setenv("BENCH_RANDOM_WEIGHTS", "1")


def _jax_build(**kw):
    sys.path.insert(0, str(REPO))
    try:
        from __graft_entry__ import _build
    finally:
        sys.path.remove(str(REPO))
    return _build(**kw)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _t64(nt):
    return type(nt)(*[None if t is None else t.double() for t in nt])


def test_entry_build_matches_jax_build(no_xla_cache):
    """latent 8, 4 x 16, batch 4, seeded weights (the JAX init carried
    across): the f32 inputs equal bit for bit, the states too; one cold step
    of each, both in f64 from those inputs: u0 within 1e-10."""
    from sdf_nmpc_tpu_torch.entry import build

    over = dict(solver=dict(dtype="float64"))
    jcfg, _, jstep, jstates, jinputs = _jax_build(cfg_overrides=over, latent=L, batch=4,
                                                   layer_sizes=LAYERS)
    module, variables = jax_net(size_latent=L, layer_sizes=LAYERS, embed="pos", w0=1.0, seed=0)
    cfg, ocp, step, states, inputs = build(cfg_overrides=over, latent=L, batch=4,
                                           layer_sizes=LAYERS, device="cpu",
                                           net=port_net(module, variables))
    assert cfg.to_dict()["solver"]["dtype"] == jcfg.solver.dtype == "float64"
    for name, got, want in [*zip(inputs._fields, inputs, jinputs),
                            ("X", states.X, jstates.X), ("U", states.U, jstates.U)]:
        want = np.asarray(want)
        assert got.dtype == torch.float32 and want.dtype == np.float32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    jres = jax.jit(jax.vmap(jstep))(_f64(jstates), _f64(jinputs))
    res = step(_t64(states), _t64(inputs))
    assert (np.asarray(jres.status) == 0).all() and (res.status.numpy() == 0).all()
    d = np.abs(res.u0.numpy() - np.asarray(jres.u0)).max()
    print(f"entry.build vs _build, one f64 cold step: max |u0 port - JAX| {d:.3e}")
    np.testing.assert_allclose(res.u0.numpy(), np.asarray(jres.u0), rtol=0, atol=1e-10)


def test_entry_returns_u0_of_the_built_step(no_xla_cache, monkeypatch):
    """entry() builds 32 scenarios and its fn gives the step's u0."""
    from sdf_nmpc_tpu_torch import entry as entry_mod

    build = entry_mod.build
    monkeypatch.setattr(entry_mod, "build", lambda **kw: build(
        **{**kw, "latent": L, "layer_sizes": LAYERS,
           "cfg_overrides": dict(mpc=dict(N=4), solver=dict(qp_iters=4))}))
    fn, (states, inputs) = entry_mod.entry(device="cpu")
    u0 = fn(states, inputs)
    assert u0.shape == (32, 4) and torch.isfinite(u0).all()


def _jax_script(name, argv, capsys):
    """Run scripts/<name> in this process with ``argv``; its stdout."""
    old = sys.argv
    sys.argv = [str(SCRIPTS / name), *argv]
    try:
        runpy.run_path(str(SCRIPTS / name), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


def test_find_rtilde_matches_the_jax_script(capsys):
    from sdf_nmpc_tpu_torch.cli import find_rtilde

    want = float(_jax_script("find_rtilde.py", [], capsys).split("=")[1])
    got = find_rtilde.main(["default", "--device", "cpu"])
    assert capsys.readouterr().out.strip() == f"r_tilde_max = {got:.6f}"
    assert abs(got - want) <= 5e-7 + 1e-9 * abs(want), (got, want)


def test_find_amax_matches_the_jax_script(tmp_path, capsys):
    """All six modes at --vmax 1 --step 0.5, each package in its own
    directory: the grids within 1e-10, the polynomial within 1e-8, the
    surrogates' readings; each package's bdist_mlp.msgpack read by the
    other's mlp_eval gives the writer's rmse and max within 1e-6."""
    from sdf_nmpc_tpu_torch.cli import find_amax

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    args = ["--vmax", "1", "--step", "0.5"]
    jout, tout = {}, {}
    for mode in find_amax.MODES:
        jout[mode] = _jax_script("find_amax.py", ["default", mode, *args, "--out-dir", str(jdir)],
                                 capsys)
        tout[mode] = find_amax.main(["default", mode, *args, "--out-dir", str(tdir),
                                     "--device", "cpu"])
        printed = capsys.readouterr().out
        # the same line but for its directory (and mlp_fit's loss: other weights)
        want = jout[mode].replace(str(jdir), str(tdir))
        if mode.startswith("mlp"):
            printed, want = (re.sub(r"[0-9]+\.[0-9]+", "#", t) for t in (printed, want))
        assert printed == want, (printed, want)
    files = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == files == [
        "1_0.5_bdist.npy", "1_0.5_vel.npy", "bdist_mlp.msgpack", "bdist_poly_deg4_1.npy"]
    np.testing.assert_array_equal(np.load(tdir / "1_0.5_vel.npy"), np.load(jdir / "1_0.5_vel.npy"))
    for name, tol in (("1_0.5_bdist.npy", 1e-10), ("bdist_poly_deg4_1.npy", 1e-8)):
        np.testing.assert_allclose(np.load(tdir / name), np.load(jdir / name), rtol=0, atol=tol,
                                   err_msg=name)
    assert tout["grid"]["n"] == 26

    from flax import serialization

    from sdf_nmpc_tpu.nn.mlp import Mlp as JMlp
    from sdf_nmpc_tpu.theory import eval_surrogate as jeval

    jm = JMlp(size_out=1, layer_sizes=[20, 20, 20], inner_act=jnp.tanh)
    template = jm.init(jax.random.PRNGKey(0), jnp.zeros(3))
    vel, bdist = np.load(tdir / "1_0.5_vel.npy"), np.load(tdir / "1_0.5_bdist.npy")

    def jax_reading(blob):
        params = serialization.from_bytes(template, blob)
        return jeval(lambda v: jm.apply(params, v), vel, bdist)

    jfile = (jdir / "bdist_mlp.msgpack").read_bytes()
    tfile = (tdir / "bdist_mlp.msgpack").read_bytes()
    # the port's surrogate through the JAX script's mlp_eval, and unrounded
    (jdir / "bdist_mlp.msgpack").write_bytes(tfile)
    out = _jax_script("find_amax.py", ["default", "mlp_eval", *args, "--out-dir", str(jdir)],
                      capsys)
    assert out == (f"mlp: rmse {tout['mlp_eval']['rmse']:.4f}, max error "
                   f"{tout['mlp_eval']['max_err']:.4f}\n"), (out, tout["mlp_eval"])
    np.testing.assert_allclose([tout["mlp_eval"]["rmse"], tout["mlp_eval"]["max_err"]],
                               jax_reading(tfile), rtol=0, atol=1e-6)
    # the JAX surrogate through the port's mlp_eval
    (tdir / "bdist_mlp.msgpack").write_bytes(jfile)
    got = find_amax.main(["default", "mlp_eval", *args, "--out-dir", str(tdir), "--device", "cpu"])
    assert capsys.readouterr().out == jout["mlp_eval"]
    np.testing.assert_allclose([got["rmse"], got["max_err"]], jax_reading(jfile), rtol=0,
                               atol=1e-6)


def test_resolution_shift_matches_jax(monkeypatch):
    """run(scenes=2) in f64 against the same computation built from the JAX
    package in f64 on the same frustum points: the latent drift, cosine,
    NeuralDF drift and flip share within 1e-6 relative."""
    from sdf_nmpc_tpu.nn.weights import load_prod_encoder, load_prod_sdf, meta_img_shape
    from sdf_nmpc_tpu.sim import render_range_image
    from sdf_nmpc_tpu_torch.cli import resolution_shift as rs

    sys.path.insert(0, str(SCRIPTS))
    try:
        from train_latent_sdf import generate_scenes
    finally:
        sys.path.remove(str(SCRIPTS))
    pts = np.random.default_rng(3).uniform([0.2, -1.5, -1.0], [5.0, 1.5, 1.0], size=(256, 3))
    got = rs.run(alt=(135, 240), scenes=2, device="cpu", points=pts, dtype=torch.float64)

    enc, enc_vars, meta = load_prod_encoder()
    v64 = _f64(enc_vars)
    Ht, Wt = meta_img_shape(meta)
    scenes = [jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), sc)
              for sc in generate_scenes(2, seed=999, blocking=True)]

    def encode_at(H, W):
        imgs = jnp.stack([render_range_image(sc, jnp.zeros(3), jnp.eye(3), H, W, rs.HFOV, rs.VFOV,
                                             rs.DMAX) for sc in scenes])
        return np.asarray(jax.jit(lambda x: enc.apply(v64, x))(imgs[..., None]))

    lat_t, lat_a = encode_at(Ht, Wt), encode_at(135, 240)
    l2, scale = np.linalg.norm(lat_a - lat_t, axis=1), np.linalg.norm(lat_t, axis=1)
    cos = np.sum(lat_a * lat_t, axis=1) / (np.linalg.norm(lat_a, axis=1) * scale + 1e-12)
    module, params = load_prod_sdf()
    p64 = _f64(params)

    def df_of(lat):
        x = np.concatenate([np.repeat(pts[None], len(lat), 0),
                            np.repeat(lat[:, None], len(pts), 1)], -1).reshape(-1, 3 + lat.shape[1])
        return np.asarray(module.apply(p64, jnp.asarray(x)))[:, 0]

    df_t, df_a = df_of(lat_t), df_of(lat_a)
    d = np.abs(df_a - df_t)
    want = {"rel_l2_mean": np.mean(l2 / scale), "rel_l2_max": np.max(l2 / scale),
            "cos_mean": np.mean(cos), "cos_min": np.min(cos), "df_mean": d.mean(),
            "df_p95": np.percentile(d, 95), "df_max": d.max(),
            "flip_share": np.mean((df_t > rs.MARGIN) != (df_a > rs.MARGIN))}
    print({k: (got[k], float(v)) for k, v in want.items()})
    assert got["trained"] == (Ht, Wt) and got["alt"] == (135, 240)
    assert 0 < want["flip_share"] < 1
    for key, value in want.items():
        assert got[key] == pytest.approx(float(value), rel=1e-6, abs=1e-12), key


def _small_e2e(jax_side=True):
    """The e2e tick's pieces at latent 8, 4 x 16, a 36 x 64 image and N = 8
    (T = 0.6 s, the interval kept), f64:
    (port setup, JAX (cfg, ocp, state, inputs, encoder, variables))."""
    from sdf_nmpc_tpu.nn import Encoder as JEncoder
    from sdf_nmpc_tpu_torch.cli import e2e_tick
    from sdf_nmpc_tpu_torch.nn import Encoder
    from sdf_nmpc_tpu_torch.nn.weights import encoder_to_jax

    over = dict(sensor=SENSOR, solver=dict(dtype="float64"), mpc=dict(N=8, T=0.6))
    # a seeded encoder carried to flax (flax's own init runs op by op: slow)
    enc = Encoder(1, L, dropout_rate=0.0, batchnorm=False,
                  generator=torch.Generator().manual_seed(0))
    jenc = JEncoder(1, L, dropout_rate=0.0, batchnorm=False)
    jvars = encoder_to_jax(enc.state_dict())
    module, variables = jax_net(size_latent=L, layer_sizes=LAYERS, embed="pos", w0=1.0, seed=0)
    setup = e2e_tick.prepare("cpu", encoder=enc.double(), cfg_overrides=over, latent=L,
                             layer_sizes=LAYERS, net=port_net(module, variables))
    setup = setup._replace(state=_t64(setup.state), inputs=_t64(setup.inputs))
    if not jax_side:
        return setup, None
    cfg, ocp, _, states, inputs = _jax_build(cfg_overrides=over, latent=L, batch=1,
                                             layer_sizes=LAYERS)
    first = lambda t: _f64(jax.tree.map(lambda x: x[0], t))
    return setup, (cfg, ocp, first(states), first(inputs), jenc, _f64(jvars))


def test_e2e_ticks_match_the_jax_tick(no_xla_cache):
    """Three chained ticks (encode, latent into p, one steady step, the
    image carrying 1e-12 u0[0]) against scripts/e2e_tick.py's tick built
    from the JAX package, f64 on both sides: u0 within 1e-8 at each tick."""
    from sdf_nmpc_tpu.solver import make_rti_step as jmake
    from sdf_nmpc_tpu_torch.cli import e2e_tick

    setup, (cfg, ocp, st0, inp0, jenc, jvars) = _small_e2e()
    H, W = SENSOR["shape_imgs"][1:]
    img = np.random.default_rng(2).uniform(0.05, 1.0, size=(H, W))
    warm_step = jmake(ocp, cfg, with_evals=False, budget="steady")
    latent_start = ocp.layout.latent_start

    def jtick(carry, _):  # scripts/e2e_tick.py:89-96
        img, st = carry
        latent = jenc.apply(jvars, img)[0]
        p = inp0.p.at[:, latent_start:].set(latent[None, :])
        res = warm_step(st, inp0._replace(p=p))
        img = img + 1e-12 * res.u0[0]
        return (img, res.state), (res.u0, res.status)

    chain = jax.jit(lambda img, st: jax.lax.scan(jtick, (img, st), None, length=3)[1])
    want_u0, want_status = chain(jnp.asarray(img)[None, :, :, None], st0)

    tick, _ = e2e_tick.make_tick(setup)
    x, st = torch.as_tensor(img)[None, None], setup.state
    for k in range(3):
        x, res = tick(x, st)
        st = res.state
        d = np.abs(res.u0[0].numpy() - np.asarray(want_u0[k])).max()
        print(f"tick {k}: max |u0 port - JAX| {d:.3e}")
        assert int(res.status[0]) == int(want_status[k]) == 0
        np.testing.assert_allclose(res.u0[0].numpy(), np.asarray(want_u0[k]), rtol=0, atol=1e-8)


def test_e2e_run_reads_every_tick(capsys):
    """run() on the CPU at the small sizes: every step it ran (1 + repeat
    tick chains, repeat solve-only chains) is OK and finite, and it prints
    the JAX script's host, device and end-to-end lines."""
    from sdf_nmpc_tpu_torch.cli import e2e_tick

    setup, _ = _small_e2e(jax_side=False)
    setup = setup._replace(encoder=setup.encoder.float(), state=_t32(setup.state),
                           inputs=_t32(setup.inputs),
                           cfg=setup.cfg.replace(solver=dict(dtype="float32")))
    out = e2e_tick.run(K=2, repeat=2, setup=setup)
    lines = capsys.readouterr().out
    assert out["n_solves"] == 2 * (1 + 2) + 2 * 2 == out["n_ok"] and out["u0_finite"]
    for head in ("host  : ring.push", "device: e2e tick (encode 36x64 + RTI solve) median",
                 "END-TO-END TICK (host + on-device):"):
        assert head in lines, lines
    assert "tunnel" not in lines
    assert out["cmd"].shape == (4,) and np.isfinite(out["cmd"]).all()


def _t32(nt):
    return type(nt)(*[None if t is None else t.float() for t in nt])


# The trained decoder against flax, both f64, in a fresh interpreter with one
# thread per library and no persistent compilation cache (as
# test_torch_config3.py holds the trained encoder): the latents of config-3
# scenes 0 and 1 (the port's f64 render and trained encoder) decoded by each.
_DECODER = """
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)
import jax.numpy as jnp
import torch
torch.set_num_threads(1)
from flax import serialization
from sdf_nmpc_tpu.nn.vae import Decoder as JDecoder
from sdf_nmpc_tpu_torch.config import default_config
from sdf_nmpc_tpu_torch.nn.weights import WEIGHTS_DIR, load_prod_decoder
from sdf_nmpc_tpu_torch.perception import VaeRuntime
from sdf_nmpc_tpu_torch.utils import accuracy

cfg = default_config()
cpu = torch.device("cpu")
enc = accuracy.config3_encoder(cfg, torch.float64, cpu)
with torch.no_grad():
    z = enc(accuracy.config3_images(cfg, torch.float64, cpu, n=2)[:, None]).numpy()
vae = VaeRuntime(cfg, enc, load_prod_decoder(device=cpu).double(), device=cpu)
port = []
for row in z:
    vae.set_latent(row)
    port.append(vae.decode())
jvars = serialization.msgpack_restore((WEIGHTS_DIR / "vae_decoder.msgpack").read_bytes())
jdec = JDecoder(1, 128, (1, 270, 480), dropout_rate=0.0, batchnorm=True)
flax = np.asarray(jax.jit(lambda x: jdec.apply(jax.tree.map(
    lambda a: jnp.asarray(a, jnp.float64), jvars), x))(jnp.asarray(z)))[..., 0]
np.savez(sys.argv[1], port=np.stack(port), flax=flax, z=z)
print(json.dumps({"x64": bool(jax.config.jax_enable_x64),
                  "dtype": str(vae.decoded.dtype)}))
"""


def test_trained_decoder_matches_flax_f64(tmp_path):
    """The trained decoder (weights/vae_decoder.msgpack, batch norm, 270 x
    480) through VaeRuntime.decode on the latents of config-3 scenes 0 and
    1, against flax on the same latents, both f64: 1e-9."""
    out = tmp_path / "decoder.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
           "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _DECODER, str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info == {"x64": True, "dtype": "torch.float64"}, info
    got = dict(np.load(out))
    d = np.abs(got["port"] - got["flax"]).max()
    print(f"trained decoder, 2 config-3 latents: max |port - flax| {d:.3e}")
    assert got["port"].shape == got["flax"].shape == (2, 270, 480)
    assert 0 < got["flax"].min() and got["flax"].max() < 1
    np.testing.assert_allclose(got["port"], got["flax"], rtol=0, atol=1e-9)
