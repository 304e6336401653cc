"""The port's scenario scale-out (``sdf_nmpc_tpu_torch.parallel``) against the
JAX package's mesh: two gloo processes hold the sharded f64 step of
tests/test_controller.py::test_sharded_batch_on_mesh's batch and the KKT
statistics of a batch with the SDF constraint on against the JAX mesh's,
and one data-parallel AdamW step against optax; shard_batch's blocks
against JAX's per-device shards; the one-rank mesh and mesh=None against
the plain step.

The two ranks run this file as a script (``--child``), torch only; each
writes what it gathered to an npz that the test reads."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
B = 16  # test_sharded_batch_on_mesh's batch
WORLD = 2
DP_ROWS = 8 * WORLD
SPAWN_TIMEOUT = 110  # seconds for the two ranks together
NOSDF_F64 = dict(flags=dict(enable_sdf=False), solver=dict(dtype="float64"))
# the port's f64 step against the JAX package's, sharded or not: its own f64
# floor on this batch (6.0e-11 on u0, on its single-process step as well)
JAX_F64_ATOL = 1e-10
KKT_FLOOR = 1e-7  # both packages' KKT residuals on this batch: 7e-15 to 2.4e-8
SDF_B, SDF_N, SDF_SEED = 4, 20, 17  # tests/test_torch_controller.py's batched-step batch
# the KKT statistics against JAX's on that batch, as test_make_batched_step_matches_jax
# holds the unsharded step's: its largest residual is a scenario short of convergence
KKT_RTOL = 1e-3


def _port_cfg(sdf=False):
    """The port's config of the no-SDF batch, or with ``sdf`` that of the
    batch with the narrow network (tests/test_torch_rti_step.py's)."""
    from sdf_nmpc_tpu_torch.config import default_config

    if sdf:
        return default_config().replace(nn=dict(size_latent=16), solver=dict(dtype="float64"))
    return default_config().replace(**NOSDF_F64)


def _child(rank: int, port: int, work: Path) -> None:
    """One gloo rank: the sharded step and the data-parallel step."""
    torch.set_num_threads(1)
    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.parallel import (Mesh, gather_batch, initialize_multihost,
                                             make_batched_step, make_dp_train_step, shard_batch,
                                             shutdown)
    from sdf_nmpc_tpu_torch.solver import SolveInputs, SolverState, init_state

    data = np.load(work / "inputs.npz")
    mesh = initialize_multihost(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    try:
        cfg = _port_cfg()
        ocp = build_ocp(cfg, device="cpu")
        inputs = SolveInputs(*[torch.as_tensor(data[k]) for k in SolveInputs._fields])
        states = SolverState(X=torch.as_tensor(data["X"]), U=torch.as_tensor(data["U"]))
        res, stats = make_batched_step(ocp, cfg, mesh=mesh)(shard_batch(states, mesh),
                                                            shard_batch(inputs, mesh))
        full = gather_batch(res, mesh)
        whole = Mesh(torch.device("cpu"), 0, 1)
        plain, _ = make_batched_step(ocp, cfg)(shard_batch(states, whole),
                                               shard_batch(inputs, whole))

        net = torch.load(work / "net.pt", weights_only=False)
        opt = torch.optim.AdamW(net.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
        loss = make_dp_train_step(net, opt, mesh)(*shard_batch((data["x"], data["y"]), mesh))
        out = {"u0": full.u0.numpy(), "X": full.state.X.numpy(), "U": full.state.U.numpy(),
               "status": full.status.numpy(), "kkt": full.kkt_residual.numpy(),
               "plain_u0": plain.u0.numpy(), "plain_X": plain.state.X.numpy(),
               "plain_status": plain.status.numpy(), "local_u0": res.u0.numpy(),
               "stats": np.array([float(s) for s in stats]), "loss": loss.numpy()}
        out.update({f"p_{k}": v.detach().numpy() for k, v in net.state_dict().items()})

        # the batch with the SDF constraint on, whose residuals are above the floor
        sdf = np.load(work / "sdf_inputs.npz")
        scfg = _port_cfg(sdf=True)
        socp = build_ocp(scfg, sdf=torch.load(work / "sdf_net.pt", weights_only=False),
                         sdf_max_df=1.0, device="cpu")
        sinputs = SolveInputs(*[torch.as_tensor(sdf[k]) for k in SolveInputs._fields])
        sstates = init_state(socp, sinputs.x0, torch.float64)
        sres, sstats = make_batched_step(socp, scfg, mesh=mesh)(shard_batch(sstates, mesh),
                                                                shard_batch(sinputs, mesh))
        sfull = gather_batch(sres, mesh)
        out.update(sdf_u0=sfull.u0.numpy(), sdf_status=sfull.status.numpy(),
                   sdf_kkt=sfull.kkt_residual.numpy(),
                   sdf_stats=np.array([float(v) for v in sstats]))
        np.savez(work / f"rank{rank}.npz", **out)
    finally:
        shutdown()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's sharded step over its 8-device mesh on the batch of
    test_sharded_batch_on_mesh, and one optax adamw step on the full batch;
    the inputs written for the ranks."""
    import jax
    import jax.numpy as jnp
    import optax

    from sdf_nmpc_tpu.config import default_config
    from sdf_nmpc_tpu.nn import init_neural_df
    from sdf_nmpc_tpu.ocp import build_ocp
    from sdf_nmpc_tpu.parallel import make_batched_step, make_mesh, shard_batch, stack_tree
    from sdf_nmpc_tpu.solver import init_state
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.nn.weights import params_from_jax
    from tests.test_sdf_nmpc import build_inputs, hover_x0

    cfg = default_config().replace(**NOSDF_F64)
    ocp = build_ocp(cfg)
    mesh = make_mesh()
    assert mesh.devices.size == 8
    rng = np.random.default_rng(7)
    x0s = np.tile(hover_x0(), (B, 1))
    x0s[:, :3] += rng.normal(size=(B, 3)) * 0.5
    inputs = stack_tree([build_inputs(cfg, ocp, x0s[i], flag=0.0) for i in range(B)])
    states = stack_tree([init_state(ocp, x0s[i]) for i in range(B)])
    sh_in, sh_st = shard_batch(inputs, mesh), shard_batch(states, mesh)
    res, stats = make_batched_step(ocp, cfg, mesh=mesh)(sh_st, sh_in)

    module, params = init_neural_df(size_latent=8, layer_sizes=(16, 16, 16, 16), seed=1)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    drng = np.random.default_rng(1)
    x = drng.normal(size=(DP_ROWS, 11))
    y = drng.normal(size=(DP_ROWS, 1))
    tx = optax.adamw(1e-3)

    def loss_fn(p):
        return jnp.mean((module.apply(p, x) - y) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    work = tmp_path_factory.mktemp("sharding")
    # the JAX states as they are (init_state's f32 rounding of x0), in f64
    np.savez(work / "inputs.npz", x=x, y=y, X=np.asarray(states.X, np.float64),
             U=np.asarray(states.U, np.float64),
             **{k: np.asarray(v) for k, v in inputs._asdict().items()})
    net = NeuralDF(size_latent=8, layer_sizes=(16, 16, 16, 16), w0=module.w0, embed=module.embed,
                   act=module.act).double()  # f64 before the load: no f32 rounding
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    torch.save(net, work / "net.pt")

    # the batch of test_make_batched_step_matches_jax (SDF on, a narrow
    # network), sharded over two of the JAX mesh's devices as over two ranks
    from _torch_port import port_net
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from test_torch_controller import _nets
    from test_torch_rti_step import _configs, _jax_inputs, _port_inputs, _scenarios

    jc, _ = _configs(dtype="float64")
    smodule, sv64, _ = _nets()
    socp = build_ocp(jc, sdf_fn=make_sdf_fn(smodule, sv64), sdf_max_df=1.0)
    x0, p, yr, W = _scenarios(jc, SDF_N, SDF_B, seed=SDF_SEED)
    smesh = make_mesh(WORLD)
    sstates = jax.vmap(lambda x: init_state(socp, x, jnp.float64))(jnp.asarray(x0))
    sres, sstats = make_batched_step(socp, jc, mesh=smesh)(
        shard_batch(sstates, smesh), shard_batch(_jax_inputs(x0, p, yr, W, SDF_N, jnp.float64),
                                                 smesh))
    np.savez(work / "sdf_inputs.npz", **{k: v.numpy() for k, v in _port_inputs(
        x0, p, yr, W, SDF_N, torch.float64)._asdict().items()})
    torch.save(port_net(smodule, sv64), work / "sdf_net.pt")
    return dict(work=work, res=jax.tree.map(np.asarray, res), stats=[float(s) for s in stats],
                sdf_res=jax.tree.map(np.asarray, sres), sdf_stats=[float(v) for v in sstats],
                sh_in=sh_in, inputs=inputs, loss=float(loss),
                params={k: v.numpy() for k, v in
                        params_from_jax(jax.tree.map(np.asarray, new_params)).items()})


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Run the two gloo ranks once; their npz outputs."""
    from sdf_nmpc_tpu_torch.cli.dryrun_multiprocess import free_port

    work, port = jax_side["work"], free_port()
    procs = [subprocess.Popen([sys.executable, __file__, "--child", str(r), str(port), str(work)],
                              cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r]}"
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]


def test_two_gloo_ranks_match_jax_mesh(jax_side, ranks):
    """The gathered f64 results of the two ranks equal the JAX package's
    sharded step over 8 devices (u0 and X within JAX_F64_ATOL, the
    statuses) and the port's single-process step on the full batch (u0, X,
    statuses) bit for bit; every rank holds the same gathered tree and the
    same BatchStats.  The counts equal JAX's; max_kkt is the largest gathered
    residual and mean_kkt their mean within 1e-14.  The residuals themselves
    sit at the QP's floating-point floor on both sides, where they read
    noise: the JAX step's own max moves from 1.15e-8 to 2.40e-8 when its
    start states are rounded to f64 instead of f32, so on this batch both
    statistics are held below KKT_FLOOR against JAX; they are compared with
    JAX's value by value on the SDF batch
    (test_two_gloo_ranks_kkt_stats_match_jax_mesh)."""
    want = jax_side["res"]
    for out in ranks:
        np.testing.assert_allclose(out["u0"], want.u0, rtol=0, atol=JAX_F64_ATOL)
        np.testing.assert_allclose(out["X"], want.state.X, rtol=0, atol=JAX_F64_ATOL)
        np.testing.assert_array_equal(out["status"], want.status)
        n_ok, n_failed, max_kkt, mean_kkt = out["stats"]
        assert (n_ok, n_failed) == tuple(jax_side["stats"][:2]) == (B, 0)
        assert max(max_kkt, mean_kkt, *jax_side["stats"][2:]) < KKT_FLOOR
        assert max_kkt == out["kkt"].max()
        np.testing.assert_allclose(mean_kkt, out["kkt"].mean(), rtol=1e-14)
        np.testing.assert_array_equal(out["u0"], out["plain_u0"])
        np.testing.assert_array_equal(out["X"], out["plain_X"])
        np.testing.assert_array_equal(out["status"], out["plain_status"])
        for k in ("u0", "X", "stats"):
            np.testing.assert_array_equal(out[k], ranks[0][k])
    for r, out in enumerate(ranks):  # each rank solved its own block
        np.testing.assert_array_equal(out["local_u0"], out["u0"][r * B // 2:(r + 1) * B // 2])


def test_two_gloo_ranks_kkt_stats_match_jax_mesh(jax_side, ranks):
    """On the batch of test_make_batched_step_matches_jax (f64, N=20, B=4,
    the SDF constraint on a narrow network), where the residuals read above
    the floor, the two ranks' BatchStats equal the JAX package's sharded
    step over two devices: the counts exactly, max_kkt and mean_kkt within
    KKT_RTOL (the bound of the unsharded comparison); u0 within 1e-6 and the
    statuses equal; the stats the reduction of the gathered residuals."""
    want, jstats = jax_side["sdf_res"], jax_side["sdf_stats"]
    assert jstats[2] > KKT_FLOOR  # above the floor, so the comparison reads the residuals
    for out in ranks:
        np.testing.assert_allclose(out["sdf_u0"], want.u0, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out["sdf_status"], want.status)
        n_ok, n_failed, max_kkt, mean_kkt = out["sdf_stats"]
        assert (n_ok, n_failed) == tuple(jstats[:2])
        np.testing.assert_allclose(max_kkt, jstats[2], rtol=KKT_RTOL)
        np.testing.assert_allclose(mean_kkt, jstats[3], rtol=KKT_RTOL)
        assert max_kkt == out["sdf_kkt"].max()
        np.testing.assert_allclose(mean_kkt, out["sdf_kkt"].mean(), rtol=1e-14)
        np.testing.assert_array_equal(out["sdf_stats"], ranks[0]["sdf_stats"])


def test_dp_step_matches_optax(jax_side, ranks):
    """One data-parallel AdamW step over the two ranks (8 rows each, f64)
    lies within 1e-12 of optax adamw(1e-3) on the full 16 rows, on both
    ranks, and the returned loss is the full batch's."""
    for out in ranks:
        np.testing.assert_allclose(out["loss"], jax_side["loss"], rtol=1e-13)
        for k, v in jax_side["params"].items():
            np.testing.assert_allclose(out[f"p_{k}"], v, rtol=0, atol=1e-12, err_msg=k)


def test_shard_batch_blocks_match_jax(jax_side):
    """shard_batch's block for rank r of 8 is the JAX mesh's shard on its
    r-th device, leaf by leaf (P(SCENARIO_AXIS) on B = 16: two rows each)."""
    from sdf_nmpc_tpu_torch.parallel import SCENARIO_AXIS, Mesh, shard_batch

    assert SCENARIO_AXIS == "scenario"
    sh_in = jax_side["sh_in"]
    host = {k: np.asarray(v) for k, v in jax_side["inputs"]._asdict().items()}
    devices = list(sh_in.x0.sharding.mesh.devices.flat)
    for r, device in enumerate(devices):
        got = shard_batch(host, Mesh(torch.device("cpu"), r, len(devices)))
        for k, leaf in sh_in._asdict().items():
            (want,) = [s.data for s in leaf.addressable_shards if s.device == device]
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want), err_msg=k)


def test_indivisible_batch_raises():
    """A batch the mesh's size does not divide raises, as JAX's sharding
    does; so do a mesh wider than the world and a mesh that is not a Mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from sdf_nmpc_tpu.parallel import make_mesh as jmesh
    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.parallel import Mesh, make_batched_step, make_mesh, shard_batch

    x = np.zeros((15, 3))
    with pytest.raises(ValueError, match="15"):
        shard_batch({"x": x}, Mesh(torch.device("cpu"), 0, 2))
    with pytest.raises(ValueError):
        jax.device_put(x, NamedSharding(jmesh(2), PartitionSpec("scenario")))
    with pytest.raises(ValueError, match="initialize_multihost"):
        make_mesh(n_devices=2, device="cpu")
    cfg = _port_cfg()
    with pytest.raises(TypeError, match="Mesh"):
        make_batched_step(build_ocp(cfg, device="cpu"), cfg, mesh=object())


def test_mesh_none_and_one_rank_mesh_unchanged():
    """mesh=None is the RTI step plus the local reductions, bit for bit; a
    one-rank mesh outside torch.distributed (make_mesh) gives the same
    results bit for bit and the same stats, the mean within 1e-14."""
    from sdf_nmpc_tpu_torch.cli.dryrun_multiprocess import build_dryrun
    from sdf_nmpc_tpu_torch.parallel import gather_batch, make_batched_step, make_mesh, shard_batch
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    cfg, ocp, states, inputs = build_dryrun(6, "cpu", dtype=torch.float64)
    want = make_rti_step(ocp, cfg, budget="cold", with_evals=False)(states, inputs)
    res, stats = make_batched_step(ocp, cfg)(states, inputs)
    assert res.evals is None and res.state.qp_duals is None
    for a, b in zip((*res.state[:2], *res[1:5]), (*want.state[:2], *want[1:5])):
        assert torch.equal(a, b)
    assert int(stats.n_ok) == int((want.status == 0).sum()) == 6 and int(stats.n_failed) == 0
    assert torch.equal(stats.max_kkt, want.kkt_residual.amax())
    assert torch.equal(stats.mean_kkt, want.kkt_residual.mean())

    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.device.type) == (0, 1, None, "cpu")
    res1, stats1 = make_batched_step(ocp, cfg, mesh=mesh)(shard_batch(states, mesh),
                                                          shard_batch(inputs, mesh))
    assert torch.equal(gather_batch(res1.u0, mesh), res.u0)
    assert torch.equal(res1.status, res.status)
    assert stats1.n_ok.dtype == stats.n_ok.dtype
    assert [int(stats1.n_ok), int(stats1.n_failed)] == [int(stats.n_ok), int(stats.n_failed)]
    assert torch.equal(stats1.max_kkt, stats.max_kkt)
    np.testing.assert_allclose(float(stats1.mean_kkt), float(stats.mean_kkt), rtol=1e-14)


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    sys.path.insert(0, str(ROOT))
    _child(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
