"""The port's runtime (runtime/native.py FrameRing, runtime/mission.py
MissionServer) against the JAX package's, on the CPU.

The frame rings build the same unchanged ``csrc/frame_ring.cpp`` and give
the same frames bit for bit.  The mission servers run the scripted
sequences of tests/test_mission.py side by side, each around its package's
f64 Nmpc (a seeded narrow NeuralDF, latent 8) and VaeRuntime (a seeded
f64 encoder on a 30 x 48 sensor), images fed through ``feed_image``, the
plant following the JAX controller's prediction: modes, flags, counters
and waypoint counts equal, u within 1e-6 (the port's chained-tick f64
agreement, tests/test_torch_nosdf.py), the clipped command within 20e-6.

The takeoff and goto sequence flies its waypoints with the collision flag
on.  With the SDF rows active near the obstacle the chained warm-started
ticks amplify the last bits: the JAX controller against itself turns a
1e-12 change of one state into more than 1e-6 of u within a few ticks.
So on that leg each tick starts the port's solver from the JAX
controller's warm start (X, U and the QP duals) and u is held at 1e-6 per
tick; the chained flag-on leg of the second test holds at 1e-6 too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import jax_net, one_torch_thread, port_net  # noqa: F401  (fixtures)
from test_torch_vae import _init, _perturbed

L = 8
TOL = 1e-6
SENSOR = dict(shape_imgs=[1, 30, 48])


def _configs(**upd):
    from sdf_nmpc_tpu.config import default_config as jcfg
    from sdf_nmpc_tpu_torch.config import default_config as tcfg

    upd = {"nn": dict(size_latent=L), "sensor": SENSOR, "solver": dict(dtype="float64"), **upd}
    return jcfg().replace(**upd), tcfg().replace(**upd)


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, port cfg, JAX Nmpc, port Nmpc, JAX VaeRuntime, port VaeRuntime)."""
    from sdf_nmpc_tpu.controller import Nmpc as JNmpc
    from sdf_nmpc_tpu.nn import Encoder as JEnc
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.perception import VaeRuntime as JRuntime
    from sdf_nmpc_tpu_torch.controller import Nmpc
    from sdf_nmpc_tpu_torch.nn.vae import Encoder
    from sdf_nmpc_tpu_torch.nn.weights import encoder_from_jax
    from sdf_nmpc_tpu_torch.perception import VaeRuntime

    jc, tc = _configs()
    module, variables = jax_net(size_latent=L, embed="oct", act="sin", w0=2.0, seed=3)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    jn = JNmpc(jc, sdf_fn=make_sdf_fn(module, v64))
    tn = Nmpc(tc, sdf=port_net(module, variables), device="cpu")
    ev = _perturbed(_init(JEnc(1, L, 0.0, True), 4, jnp.zeros((1, 30, 48, 1)), with_logvar=True),
                    4)
    enc = Encoder(1, L, 0.0, True).double()
    enc.load_state_dict(encoder_from_jax(ev))
    jvae = JRuntime(jc, jax.tree.map(jnp.asarray, ev), None, batchnorm=True)
    return jc, tc, jn, tn, jvae, VaeRuntime(tc, enc, device="cpu")


def _servers(pair, **mission):
    from sdf_nmpc_tpu.runtime import MissionServer as JServer
    from sdf_nmpc_tpu_torch.runtime import MissionServer

    jc, tc, jn, tn, jvae, tvae = pair
    if mission:
        jc, tc = jc.replace(mission=mission), tc.replace(mission=mission)
    return JServer(jc, jn, jvae), MissionServer(tc, tn, tvae)


def _frame(seed=0):
    """A raw 30 x 48 depth frame in mm with a close obstacle in the middle."""
    rng = np.random.default_rng(seed)
    raw = rng.uniform(2500, 6000, size=(30, 48))
    raw[8:22, 16:32] = rng.uniform(900, 1400, size=(14, 16))
    return raw.astype(np.float32)


def _same_tick(js, ts, label):
    assert ts.mode.value == js.mode.value, label
    for name in ("flag_active", "fail_count", "did_reset", "ref_timed_out", "img_timed_out",
                 "wps_left"):
        assert getattr(ts, name) == getattr(js, name), f"{label}: {name}"
    np.testing.assert_allclose(ts.u, js.u, rtol=0, atol=TOL, err_msg=label)
    np.testing.assert_allclose(ts.cmd, js.cmd, rtol=0, atol=20 * TOL, err_msg=label)


def _both(servers, method, *args, **kw):
    return [getattr(s, method)(*args, **kw) for s in servers]


def _same_warm_start(servers):
    """Start the port's next solve from the JAX controller's warm start:
    its shooting iterate and QP duals, given the batch axis of one.  The
    budget's counters are compared, not copied."""
    import torch

    from sdf_nmpc_tpu_torch.solver.qp import QpDuals
    from sdf_nmpc_tpu_torch.solver.sqp import SolverState

    jn, tn = servers[0].nmpc, servers[1].nmpc
    assert (tn._warm_tick, tn._clean_warm_ticks) == (jn._warm_tick, jn._clean_warm_ticks)
    js = jn._solver_state
    as_port = lambda a: torch.as_tensor(np.array(a))[None]
    duals = None if js.qp_duals is None else QpDuals(*map(as_port, js.qp_duals))
    tn._solver_state = SolverState(X=as_port(js.X), U=as_port(js.U), qp_duals=duals)


def _fly(servers, pair, x, t, n, label, image_every=None, same_warm_start=False):
    """n ticks of both servers, each fed x (and, every ``image_every``
    ticks, the frame); x then follows the JAX controller's prediction.
    With ``same_warm_start`` each tick starts both solvers from the JAX
    controller's warm start."""
    jn = pair[2]
    tick = None
    for k in range(n):
        _both(servers, "feed_state", x, t)
        if image_every and k % image_every == 0:
            _both(servers, "feed_image", _frame(k), x[:3], np.eye(3), t)
        if same_warm_start:
            _same_warm_start(servers)
        js, ts = _both(servers, "tick", t)
        _same_tick(js, ts, f"{label}, tick {k}")
        tick = js
        x = np.asarray(jn.get_matrices()[0][1])
        t += 0.02
    return x, tick, t


def _hover_x0():
    x = np.zeros(10)
    x[3] = 1.0
    return x


def test_takeoff_then_goto_with_images(pair):
    from sdf_nmpc_tpu.runtime import MissionMode
    from sdf_nmpc_tpu.ref_gen import Waypoint as JWaypoint
    from sdf_nmpc_tpu_torch.ref_gen import Waypoint

    servers = _servers(pair)
    x = _hover_x0()
    _both(servers, "feed_state", x, 0.0)
    _both(servers, "takeoff")
    _both(servers, "set_flag", True)
    x, tick, t = _fly(servers, pair, x, 0.0, 6, "takeoff", image_every=2)
    assert tick.mode == MissionMode.HOVER and tick.flag_active
    zref = pair[0].ref.zref
    servers[0].goto([JWaypoint([1.0, 0.5, zref]), JWaypoint([2.0, 0.0, zref])])
    servers[1].goto([Waypoint([1.0, 0.5, zref]), Waypoint([2.0, 0.0, zref])])
    x, tick, t = _fly(servers, pair, x, t, 8, "goto", image_every=3, same_warm_start=True)
    assert tick.mode == MissionMode.WPS and tick.wps_left == 2 and tick.flag_active
    _both(servers, "goto")  # the config's waypoint rows, yaw included
    np.testing.assert_allclose(servers[1]._wps[0].q, servers[0]._wps[0].q, rtol=0, atol=1e-15)
    _fly(servers, pair, x, t, 3, "goto rows", same_warm_start=True)


def _flag_on_leg(servers, pair, eps=0.0):
    """Takeoff (6 ticks), then two waypoints with the flag on (6 ticks), an
    image every other tick; ``eps`` moves the state of the first waypoint
    tick.  x follows the first server's prediction.  Returns u per tick,
    one row per server."""
    from sdf_nmpc_tpu.ref_gen import Waypoint as JWaypoint
    from sdf_nmpc_tpu_torch.ref_gen import Waypoint

    x, t, us = _hover_x0(), 0.0, []
    _both(servers, "feed_state", x, t)
    _both(servers, "takeoff")
    _both(servers, "set_flag", True)
    for k in range(12):
        if k == 6:
            zref = pair[0].ref.zref
            for s, wp in zip(servers, (JWaypoint, Waypoint)):
                s.goto([wp([1.0, 0.5, zref]), wp([2.0, 0.0, zref])])
        _both(servers, "feed_state", x + (eps if k == 6 else 0.0), t)
        if k % 2 == 0:
            _both(servers, "feed_image", _frame(k), x[:3], np.eye(3), t)
        us.append([tick.u for tick in _both(servers, "tick", t)])
        x = np.asarray(servers[0].nmpc.get_matrices()[0][1])
        t += 0.02
    return np.asarray(us).transpose(1, 0, 2)


def test_flag_on_waypoints_track_as_jax_tracks_itself(pair):
    """Twelve chained ticks, the flag on throughout, each solver carrying
    its own warm start: u within 1e-6 on every tick.  On the waypoint leg
    the JAX controller against itself, one state moved by 1e-12, drifts
    beyond 1e-6: the leg does amplify, and the port still holds."""
    jax_u, port_u = _flag_on_leg(_servers(pair), pair)
    (moved,) = _flag_on_leg(_servers(pair)[:1], pair, eps=1e-12)
    port_d = np.abs(port_u - jax_u).max(-1)
    self_d = np.abs(moved - jax_u).max(-1)
    print("port - JAX per tick:", np.array2string(port_d, precision=2, max_line_width=200))
    print("JAX moved by 1e-12 - JAX per tick:", np.array2string(self_d, precision=2,
                                                            max_line_width=200))
    assert port_d.max() <= TOL
    assert self_d[6:].max() > TOL  # the leg does amplify


def test_joystick_lowpass_and_timeout(pair):
    servers = _servers(pair)
    _both(servers, "feed_state", _hover_x0(), 0.0)
    _both(servers, "feed_joystick", [1.0, 0.0, 0.0, 0.0], t=0.0)
    np.testing.assert_array_equal(servers[1]._joy, servers[0]._joy)
    _same_tick(*_both(servers, "tick", 0.0), "joystick")
    t_late = pair[0].mission.timeout_ref + 0.1
    _both(servers, "feed_state", _hover_x0(), t_late)
    js, ts = _both(servers, "tick", t_late)
    _same_tick(js, ts, "joystick timed out")
    assert ts.ref_timed_out


def test_image_watchdog_vetoes_flag(pair):
    servers = _servers(pair)
    _both(servers, "feed_state", _hover_x0(), 0.0)
    _both(servers, "set_flag", True)
    js, ts = _both(servers, "tick", 0.0)  # no image yet: vetoed
    _same_tick(js, ts, "no image")
    assert ts.img_timed_out and not ts.flag_active
    _both(servers, "feed_image", _frame(), np.zeros(3), np.eye(3), 0.0)
    np.testing.assert_allclose(pair[5].latent.numpy(), np.asarray(pair[4].latent), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(servers[1].nmpc.p, servers[0].nmpc.p, rtol=0, atol=1e-12)
    js, ts = _both(servers, "tick", 0.5)
    _same_tick(js, ts, "fresh image")
    assert ts.flag_active
    js, ts = _both(servers, "tick", pair[0].mission.timeout_img + 0.6)
    _same_tick(js, ts, "stale image")
    assert ts.img_timed_out and not ts.flag_active and servers[1].get_flag()


def test_stop_resets_and_yaw_mode(pair):
    servers = _servers(pair)
    _both(servers, "feed_state", _hover_x0(), 0.0)
    _both(servers, "set_yaw_mode", True)
    assert [s.get_yaw_mode() for s in servers] == [True, True]
    assert servers[1].refgen.force_yaw_current
    _both(servers, "set_flag", True)
    _both(servers, "goto")
    _both(servers, "stop")
    assert servers[1]._mode.value == servers[0]._mode.value == "idle"
    assert not servers[1].get_flag() and servers[1]._wps == []
    _both(servers, "feed_state", _hover_x0(), 1.0)
    _same_tick(*_both(servers, "tick", 1.0), "idle after stop")


def test_fail_reset_after_max_solver_fail(pair, monkeypatch):
    servers = _servers(pair)
    _both(servers, "feed_state", _hover_x0(), 0.0)
    _both(servers, "hover")
    max_fail = int(pair[0].mpc.max_solver_fail)
    for n in (pair[2], pair[3]):
        monkeypatch.setattr(n, "solve", lambda: max_fail)
    js, ts = _both(servers, "tick", 0.0)
    assert ts.did_reset and js.did_reset and ts.mode.value == js.mode.value == "hover"
    assert pair[3].fail_count == pair[2].fail_count == 0


def test_stop_and_go_targets_front_waypoint(pair):
    from sdf_nmpc_tpu.ref_gen import Waypoint as JWaypoint
    from sdf_nmpc_tpu_torch.ref_gen import Waypoint

    servers = _servers(pair, stop_and_go=True)
    _both(servers, "feed_state", _hover_x0(), 0.0)
    servers[0].goto([JWaypoint([1.5, 0.0, 0.0])])
    servers[1].goto([Waypoint([1.5, 0.0, 0.0])])
    js, ts = _both(servers, "tick", 0.0)
    _same_tick(js, ts, "stop and go")
    assert ts.wps_left == 1
    np.testing.assert_allclose(pair[3].y, pair[2].y, rtol=0, atol=1e-12)


@pytest.mark.parametrize("interface", ["acc", "TRPYr", "props"])
def test_control_interfaces(pair, interface):
    """acc and TRPYr give the same clipped command; att has no propeller
    map, so 'props' raises on both sides (the port names the missing map,
    NotImplementedError; the JAX controller calls None, TypeError); an
    unknown name is refused."""
    from sdf_nmpc_tpu_torch.runtime import MissionServer

    servers = _servers(pair, control_interface=interface)
    _both(servers, "feed_state", _hover_x0(), 0.0)
    if interface == "props":
        for s, err in zip(servers, (TypeError, NotImplementedError)):
            with pytest.raises(err):
                s.tick(0.0)
        return
    js, ts = _both(servers, "tick", 0.0)
    _same_tick(js, ts, interface)
    np.testing.assert_allclose(ts.cmd, getattr(pair[3], f"get_cmd_{interface}")())
    with pytest.raises(ValueError):
        MissionServer(pair[1].replace(mission=dict(control_interface="bogus")), pair[3])


@pytest.mark.parametrize("is_depth", [True, False])
@pytest.mark.parametrize("kind", ["u16", "f32"])
def test_frame_ring_equals_jaxs(is_depth, kind):
    """Both packages' rings on the same pushes give the same frames bit for
    bit, with the same timestamps, staleness and counts."""
    from sdf_nmpc_tpu.runtime import FrameRing as JRing
    from sdf_nmpc_tpu_torch.runtime import FrameRing

    jc, tc = _configs(sensor=dict(SENSOR, is_depth=is_depth))
    rings = JRing(jc, capacity=3), FrameRing(tc, capacity=3)
    rng = np.random.default_rng(5)
    for k in range(4):
        raw = rng.integers(0, 7000, size=(30, 48)).astype(np.uint16)
        if kind == "f32":
            raw = (raw / 1000.0).astype(np.float32)  # metres
        for r in rings:
            r.push(raw, timestamp=10.0 + k)
    (jf, jts, jst), (tf, tts, tst) = [r.latest(timeout=0.5, now=13.2) for r in rings]
    assert tf.dtype == np.float32 and tf.shape == (30, 48)
    np.testing.assert_array_equal(tf, jf)
    assert (tts, tst) == (jts, jst) == (13.0, False)
    assert [r.latest(timeout=0.5, now=14.0)[2] for r in rings] == [True, True]
    assert rings[1].count == rings[0].count == 4


def test_frame_ring_refuses_wrong_frames():
    from sdf_nmpc_tpu_torch.runtime import FrameRing

    ring = FrameRing(_configs()[1])
    assert ring.latest(now=0.0) == (None, -1.0, True)
    with pytest.raises(ValueError, match="shape"):
        ring.push(np.zeros((29, 48), np.uint16))
    with pytest.raises(TypeError):
        ring.push(np.zeros((30, 48), np.int64))
