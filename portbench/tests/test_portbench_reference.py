"""The plain f64 reference against the program's own f64 step on the CPU
(its plain versions), on a few scenarios: a small seeded network and the
trained one; cold and steady budgets, and two chained steps."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.systems import rti_step as rs

ROOT = Path(__file__).resolve().parents[2]
CONF = json.loads((ROOT / "portbench/configs/config4_att_sdf.json").read_text())


def small_net(L=8, width=16, seed=0):
    """A seeded flax-layout tree of the NeuralDF at small widths."""
    rng = np.random.default_rng(seed)
    nemb = 83
    dims = {"main1_0": (nemb + L, width), "main1_1": (width, width),
            "main2_0": (width + nemb + L, width), "main2_1": (width, width), "df": (width, 1)}
    tree = {k: {"kernel": (rng.uniform(-1, 1, d) * np.sqrt(6 / d[0]) / 20).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(d[1])).astype(np.float32)}
            for k, d in dims.items()}
    tree["df"]["bias"] = np.full(1, 0.6, np.float32)
    conf = copy.deepcopy(CONF)
    conf["sdf"].update(size_latent=L, layer_sizes=[width] * 4)
    return conf, {"params": tree}, rng.standard_normal((5, L)) * 0.1


# f64 round-off, amplified by ill-conditioned interior-point phases, reads up
# to 1.4e-9 between the two f64 steps; the f32 program lies 1e-6 and more away
F64_AGREE = 1e-7


def compare(conf, tree, lat, B=5, seed=2**31 + 99):
    inp = rs.make_inputs(conf, B, seed, lat)
    prog = rs.Program(conf, tree, "cpu", overrides={"dtype": "float64"})
    from sdf_nmpc_tpu_torch.solver import SolveInputs, init_state

    si = SolveInputs(**{k: torch.as_tensor(v) for k, v in inp.items()})
    res = prog.cold(init_state(prog.ocp, si.x0, dtype=torch.float64), si)
    ref = rs.Reference(conf, tree, "cpu", block=2)
    out = [rs.gaps(res.state.X, res.state.U, res.status == 0, *ref.step(None, None, inp,
                                                                        "cold"))]
    for _ in range(2):
        X, U = res.state.X, res.state.U
        res = prog.steady(res.state, si)
        out.append(rs.gaps(res.state.X, res.state.U, res.status == 0,
                           *ref.step(X, U, inp, "steady")))
    return out


@pytest.fixture(scope="module")
def trained():
    tree, lat = rs.load_sdf(CONF, ROOT)
    return tree, lat


def test_reference_equals_the_f64_step_small_net():
    conf, tree, lat = small_net()
    for g in compare(conf, tree, lat):
        assert not g["bad"].any()
        assert float(g["u0"].max()) < F64_AGREE and float(g["traj"].max()) < F64_AGREE


def test_reference_equals_the_f64_step_trained_net(trained):
    tree, lat = trained
    for g in compare(CONF, tree, lat, B=3):
        assert not g["bad"].any()
        assert float(g["u0"].max()) < F64_AGREE and float(g["traj"].max()) < F64_AGREE


def test_the_reference_moves_the_trajectory(trained):
    """A reference that returned its input would pass a stale program."""
    tree, lat = trained
    inp = rs.make_inputs(CONF, 2, 5, lat)
    ref = rs.RtiReference(CONF, tree, "cpu")
    X, U = ref.init_state(torch.as_tensor(inp["x0"]))
    X1, U1, ok = ref.step(X, U, {k: torch.as_tensor(v) for k, v in inp.items()}, "cold")
    assert bool(ok.all()) and float((U1 - U).abs().max()) > 1e-3


def test_inputs_follow_the_seed(trained):
    _, lat = trained
    a, b, c = (rs.make_inputs(CONF, 64, s, lat) for s in (3 * 2**31, 3 * 2**31, 17))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["x0"], c["x0"]) and not np.array_equal(a["p"], c["p"])
    assert a["x0"].shape == (64, 10) and a["p"].shape == (64, 21, 145)


def test_device_inputs_equal_the_rows(trained):
    """The inputs built on the device are the rows the reference reads."""
    _, lat = trained
    scen = rs.Scenarios(CONF, 40, 123, lat)
    dev = scen.on_device("cpu", slice(8, 24))
    rows = scen.rows(np.arange(8, 24))
    for k in rows:
        assert np.array_equal(getattr(dev, k).double().numpy(), rows[k]), k


def test_encoder_reference_equals_the_f64_encoder():
    """The plain encoder against the program's encoder module in f64 on the
    CPU, on two rendered frames through both preprocessings."""
    from sdf_nmpc_tpu_torch.nn.vae import Encoder
    from sdf_nmpc_tpu_torch.nn.weights import encoder_from_jax
    from sdf_nmpc_tpu_torch.perception import clip_distance, depth2range

    from portbench import scenes
    from portbench.reference.encoder import EncoderRef, preprocess
    from portbench.reference.msgpack_tree import msgpack_restore

    conf = json.loads((ROOT / "portbench/configs/config3_perception.json").read_text())
    pc = conf["perception"]
    tree = msgpack_restore((ROOT / pc["weights"]).read_bytes())
    frames = scenes.render(scenes.draw_scenes(2, 8, 9), pc["shape"][-2:], pc["hfov"], pc["vfov"],
                           pc["dmax"], "cpu")
    x_prog = depth2range(clip_distance(frames.double(), pc["dmax"], pc["mm_resolution"]),
                         pc["hfov"], pc["vfov"])
    x_ref = preprocess(frames, pc["dmax"] / pc["mm_resolution"] * 1000, pc["hfov"], pc["vfov"])
    # the program's range map is float32 (perception/preprocessing.py)
    assert float((x_prog - x_ref).abs().max()) < 1e-6
    net = Encoder(size_latent=pc["size_latent"], batchnorm=pc["batchnorm"])
    net.load_state_dict(encoder_from_jax(tree))
    with torch.no_grad():
        z_prog = net.double().eval()(x_ref)
        z_ref = EncoderRef(tree, "cpu")(x_ref)
    assert float((z_prog - z_ref).abs().max()) < 1e-10 * (1 + float(z_ref.abs().max()))


@pytest.mark.parametrize("key, value", [("sdf_cost", True), ("recursive_feasibility", True),
                                        ("enable_sdf", False), ("uniform_dt", False)])
def test_formulation_comes_from_the_file(trained, key, value):
    """The program takes the formulation the configuration file states; the
    plain reference refuses one it does not implement, and names where
    another belongs."""
    conf = copy.deepcopy(CONF)
    (conf["ocp"] if key == "uniform_dt" else conf["flags"])[key] = value
    cfg = rs.program_config(conf)
    assert (cfg.mpc.uniform_dt if key == "uniform_dt" else cfg.flags[key]) == value
    with pytest.raises(ValueError, match="portbench/reference/"):
        rs.RtiReference(conf, trained[0], "cpu")
