"""BASELINE config 3 in the port, on the CPU: the trained encoder against
flax in f64, the rendered scene-0 image and its latent against the JAX
package's, the port's f64 render -> encode -> solve against the golden
oracle (tests/golden/config3_u0.npz) and its f32 pipeline under the 1e-3
contract on all 8 scenes."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]

# Both sides in a fresh interpreter with one thread per library and no
# persistent compilation cache (as test_torch_weights.py runs the trained
# NeuralDF): scene 0 of the config-3 workload rendered in f64 by each
# package, then each image encoded in f64 by each package's trained encoder.
_SCENE0 = """
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)
import jax.numpy as jnp
import torch
torch.set_num_threads(1)
from sdf_nmpc_tpu.config import default_config as jcfg
from sdf_nmpc_tpu.nn.weights import load_prod_encoder as jload
from sdf_nmpc_tpu.sim import render_range_image as jrender
from sdf_nmpc_tpu.utils.accuracy import _config3_scenes as jscenes
from sdf_nmpc_tpu_torch.config import default_config
from sdf_nmpc_tpu_torch.utils import accuracy

cfg = default_config()
H, W = cfg.sensor.shape_imgs[-2:]
scene = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)[0], jscenes(1))
jimg = np.asarray(jrender(scene, jnp.zeros(3), jnp.eye(3), H, W, float(cfg.sensor.hfov),
                          float(cfg.sensor.vfov), float(cfg.sensor.dmax)))
timg = accuracy.config3_images(cfg, torch.float64, torch.device("cpu"), n=1)[0].numpy()
module, variables, _ = jload(expect_img=(H, W), strict=True)
v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
jenc = jax.jit(lambda x: module.apply(v64, x))
enc = accuracy.config3_encoder(cfg, torch.float64, torch.device("cpu"))
with torch.no_grad():
    port = lambda img: enc(torch.as_tensor(img)[None, None]).numpy()[0]
    out = dict(jimg=jimg, timg=timg, port_on_port=port(timg), port_on_jax=port(jimg),
               flax_on_port=np.asarray(jenc(jnp.asarray(timg)[None, :, :, None]))[0],
               flax_on_jax=np.asarray(jenc(jnp.asarray(jimg)[None, :, :, None]))[0])
np.savez(sys.argv[1], **out)
print(json.dumps({"x64": bool(jax.config.jax_enable_x64), "torch_threads": torch.get_num_threads(),
                  "encoder_dtype": str(next(enc.parameters()).dtype)}))
"""


@pytest.fixture(scope="module")
def scene0(tmp_path_factory):
    out = tmp_path_factory.mktemp("config3") / "scene0.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
           "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _SCENE0, str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info["x64"] and info["encoder_dtype"] == "torch.float64", info
    return dict(np.load(out))


def test_trained_encoder_matches_flax_f64(scene0):
    """The trained ResNet encoder (270 x 480, batch norm, 128-d latent) on the
    rendered scene-0 image, f64 on both sides: 1e-9 covers summation order
    over ~4 GFLOP of convolutions."""
    for img in ("port", "jax"):
        got, want = scene0[f"port_on_{img}"], scene0[f"flax_on_{img}"]
        print(f"trained encoder on the {img} image: max |port - flax| "
              f"{np.abs(got - want).max():.3e}, max |z| {np.abs(want).max():.3f}")
        assert got.shape == want.shape == (128,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9, err_msg=f"{img} image")


def test_scene0_image_and_latent_match_jax(scene0):
    """The port's sphere-traced image of scene 0 equals the JAX package's
    within 1e-12 (the f32 rays and f32 scene kept, the trace in f64), and
    the latent of each package's own pipeline within 1e-9."""
    assert scene0["timg"].shape == (270, 480)
    img_d = np.abs(scene0["timg"] - scene0["jimg"]).max()
    lat_d = np.abs(scene0["port_on_port"] - scene0["flax_on_jax"]).max()
    print(f"scene 0: image max |port - JAX| {img_d:.3e}, latent {lat_d:.3e}")
    np.testing.assert_allclose(scene0["timg"], scene0["jimg"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(scene0["port_on_port"], scene0["flax_on_jax"], rtol=0, atol=1e-9)


def test_f64_config3_reproduces_the_golden():
    """The port's f64 render -> encode -> 40-iteration solve of scene 0
    reproduces the oracle's row within 1e-7, the port's f64 agreement with
    the oracles on rates (tests/test_torch_accuracy.py)."""
    from sdf_nmpc_tpu_torch.utils import accuracy

    ref = np.load(accuracy.CONFIG3_NPZ)["u0"]
    u0, status = accuracy.solve_config3_batch(dict(dtype="float64", qp_iters=40), n=1,
                                              device="cpu")
    err = float(np.abs(u0[0] - ref[0]).max())
    print(f"config 3, f64, scene 0: u0 max |port - golden| = {err:.3e}")
    assert (status == 0).all() and u0.shape == (1, ref.shape[1])
    assert err <= 1e-7, err


def test_f32_config3_meets_the_contract():
    """The f32 pipeline (the card's dtype, plain versions here) on all 8
    scenes: every status OK, u0 max <= 1e-3 against the f64 oracle."""
    from sdf_nmpc_tpu_torch.utils import accuracy

    out = accuracy.check_config3_accuracy(device="cpu")
    print(f"config 3, f32 on the CPU: {out}")
    assert out["n_scen"] == accuracy.CONFIG3_SCEN == 8
    assert out["n_ok"] == out["n_scen"], out
    assert out["u0_max_err"] <= accuracy.CONTRACT_MAX, out


def test_config3_refuses_a_missing_card():
    """No CUDA device here: the default device raises, it does not run on
    the CPU."""
    import torch

    from sdf_nmpc_tpu_torch.utils import accuracy

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        accuracy.check_config3_accuracy()
