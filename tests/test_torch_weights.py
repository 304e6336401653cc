"""The port's msgpack reader and NeuralDF against flax (f64 forward)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, one_torch_thread, port_net, t64  # noqa: F401  (fixtures)

RNG = np.random.default_rng(5)
REPO = Path(__file__).resolve().parents[1]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_msgpack_reader_equals_flax_restore():
    from flax import serialization

    from sdf_nmpc_tpu_torch.nn.weights import WEIGHTS_DIR, msgpack_restore

    data = (WEIGHTS_DIR / "sdf.msgpack").read_bytes()
    want = dict(_leaves(serialization.msgpack_restore(data)))
    got = dict(_leaves(msgpack_restore(data)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_msgpack_reader_roundtrips_flax_serialize():
    """Scalars, nested lists, numpy scalars and several dtypes, as flax writes them."""
    from flax import serialization

    from sdf_nmpc_tpu_torch.nn.weights import msgpack_restore

    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": {"c": np.float64(2.5),
            "d": np.ones((0, 4), np.float32)}, "e": 7, "f": -3, "g": "text", "h": 1.5,
            "i": None, "j": True, "k": np.float16([1, 2])}
    got = msgpack_restore(serialization.msgpack_serialize(tree))
    want = serialization.msgpack_restore(serialization.msgpack_serialize(tree))
    assert set(got) == set(want)
    for (kg, vg), (kw, vw) in zip(_leaves(got), _leaves(want)):
        assert kg == kw
        np.testing.assert_array_equal(np.asarray(vg), np.asarray(vw), err_msg=kg)


# Both forwards of the trained net, in a fresh interpreter with one thread
# per library and no persistent compilation cache: nothing that an earlier
# test of the same worker process set, no thread-count-dependent path and no
# executable compiled by another process can reach them.  Each side runs twice
# and reports the exact sum of the weights it holds, so that a failure says
# which side moved.
_TRAINED_FORWARD = """
import json, math, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)
import jax.numpy as jnp
import torch
torch.set_num_threads(1)
from sdf_nmpc_tpu.nn.weights import load_prod_sdf as jload
from sdf_nmpc_tpu_torch.nn.weights import load_prod_sdf

x = np.load(sys.argv[1])
module, variables = jload()
net = load_prod_sdf(device="cpu").double()
v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
want = [np.asarray(module.apply(v64, jnp.asarray(x))) for _ in range(2)]
got = [net(torch.as_tensor(x)).detach().numpy() for _ in range(2)]
fsum = lambda arrays: math.fsum(float(v) for a in arrays for v in np.ravel(a))
np.savez(sys.argv[2], got=got[0], want=want[0])
print(json.dumps({
    "port_repeat_max_diff": float(np.abs(got[1] - got[0]).max()),
    "flax_repeat_max_diff": float(np.abs(want[1] - want[0]).max()),
    "port_weight_sum": fsum(p.detach().numpy() for p in net.state_dict().values()),
    "flax_weight_sum": fsum(jax.tree.leaves(v64)),
    "x64": bool(jax.config.jax_enable_x64), "flax_dtype": str(want[0].dtype),
    "port_dtype": str(got[0].dtype), "torch_threads": torch.get_num_threads(),
    "port_net": [net.w0, net.embed, net.size_latent, list(net.layer_sizes)],
}))
"""


def test_trained_net_forward_matches_flax_f64(tmp_path):
    """The trained 4x256 NeuralDF (oct embedding, w0=20) on a few hundred
    points; f64 on both sides, so 1e-10 covers only summation order."""
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_latents

    lat = load_prod_latents()
    n = 300
    pos = RNG.normal(size=(n, 3)) * 1.5
    x = np.concatenate([pos, lat[RNG.integers(0, lat.shape[0], n)].astype(np.float64)], -1)
    np.save(tmp_path / "x.npy", x)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
           "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _TRAINED_FORWARD, str(tmp_path / "x.npy"),
                           str(tmp_path / "out.npz")], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    out = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(out["got"], out["want"], rtol=1e-10, atol=1e-10,
                               err_msg=json.dumps(info))
    assert info["port_net"] == [20.0, "oct", 128, [256, 256, 256, 256]]


@pytest.mark.parametrize("act", ["sin", "relu", "softplus"])
@pytest.mark.parametrize("embed", ["none", "pos", "cube", "oct", "dod", "ico"])
def test_narrow_net_all_modes_match_flax_f64(embed, act):
    module, variables = jax_net(embed=embed, act=act, w0=3.0, seed=2)
    net = port_net(module, variables)
    x = np.concatenate([RNG.normal(size=(40, 3)), RNG.normal(size=(40, 16)) * 0.3], -1)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    want = np.asarray(module.apply(v64, jnp.asarray(x)))
    got = net(t64(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("res", ["state", "latent", "none"])
def test_residual_modes_match_flax_f64(res):
    from sdf_nmpc_tpu.nn import init_neural_df

    module, variables = init_neural_df(size_latent=8, layer_sizes=(16, 16, 16, 16),
                                       embed="cube", res=res, w0=2.0, seed=4)
    net = port_net(module, variables)
    x = np.concatenate([RNG.normal(size=(10, 3)), RNG.normal(size=(10, 8))], -1)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    np.testing.assert_allclose(net(t64(x)).detach().numpy(),
                               np.asarray(module.apply(v64, jnp.asarray(x))), rtol=1e-11,
                               atol=1e-11)


def test_siren_init_from_generator_is_seeded_and_bounded():
    from sdf_nmpc_tpu_torch.nn import NeuralDF

    a = NeuralDF(size_latent=8, layer_sizes=(16, 16, 16, 16), w0=4.0,
                 generator=torch.Generator().manual_seed(3))
    b = NeuralDF(size_latent=8, layer_sizes=(16, 16, 16, 16), w0=4.0,
                 generator=torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=na)
    bound = np.sqrt(6.0 / a.main1_0.in_features) / 4.0
    assert float(a.main1_0.weight.detach().abs().max()) <= bound
