"""The port's cross-process bus against the JAX package: ``bus/remote.py``
(``BusBroker``, ``BusBridge``, the wire codec, ``NodeProcess``).

Held: ``_wire_encode`` gives the JAX package's bytes for every wire type (a
tensor image the bytes of its numpy twin) and ``_wire_decode`` reads them
back equal; bridged buses in one process exchange every type with no echo;
a port bridge and a JAX bridge talk through one broker; a client that dies
is reaped and one that comes back is served again (as
``tests/test_remote_bus.py``'s churn test); a spawned
``NodeProcess("TrajOptNode", ..., device="cpu")`` publishes the optimized
path ``array_equal`` to the in-process node's, with the thread count its
``env`` sets; a worker asked for a CUDA device it cannot reach dies before
it attaches, and the launch raises (no CPU fallback).
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from trajectory_optimization_tpu.bus import core as jcore  # noqa: E402
from trajectory_optimization_tpu.bus import messages as jmsgs  # noqa: E402
from trajectory_optimization_tpu.bus import remote as jremote  # noqa: E402
from trajectory_optimization_tpu_torch.bus import core as tcore  # noqa: E402
from trajectory_optimization_tpu_torch.bus import launch as tlaunch  # noqa: E402
from trajectory_optimization_tpu_torch.bus import messages as tmsgs  # noqa: E402
from trajectory_optimization_tpu_torch.bus import remote as tremote  # noqa: E402
from trajectory_optimization_tpu_torch.bus.nodes import TrajOptNode  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import load_path, load_point_cloud  # noqa: E402

# the worker's torch on one thread too: CPU elementwise ops on several
# threads have given identical calls different last bits
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _wait(pred, timeout=30.0, dt=0.02):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(dt)
    return pred()


def _messages(M, image=lambda a: a):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (6, 8, 3)).astype(np.uint8)
    return [
        ("/pc", M.CloudMsg(M.Header(stamp=1.0, frame_id="map", seq=1),
                           rng.normal(size=(64, 4)).astype(np.float32))),
        ("/pose", M.PoseMsg(M.Header(stamp=1.1, frame_id="map", seq=2),
                            [1.0, 2.0, 3.0], [0.0, 0.0, 0.0, 1.0])),
        ("/path", M.PathMsg(M.Header(stamp=1.2, frame_id="map", seq=3),
                            rng.normal(size=(5, 3)), np.tile([0.0, 0.0, 0.0, 1.0], (5, 1)))),
        ("/odom", M.OdometryMsg(M.Header(stamp=1.25, frame_id="odom", seq=4),
                                np.array([4.0, 5.0, 6.0]), np.array([0.0, 0.0, 0.0, 1.0]))),
        ("/info", M.CameraInfoMsg(M.Header(stamp=1.27, frame_id="cam", seq=5), 8, 6,
                                  K=(5.0, 0.0, 4.0, 0.0, 5.0, 3.0, 0.0, 0.0, 1.0))),
        ("/tf", M.TransformMsg(M.Header(stamp=1.3, frame_id="map", seq=6), "X1",
                               np.array([0.5, 0.0, 0.2]), np.array([0.0, 0.0, 0.0, 1.0]))),
        ("/img", M.ImageMsg(M.Header(stamp=1.4, frame_id="cam", seq=7), image(img),
                            encoding="rgb8")),
        ("/img/compressed", M.ImageMsg(M.Header(stamp=1.5, frame_id="cam", seq=8),
                                       np.arange(40, dtype=np.uint8), encoding="jpeg")),
    ]


def test_wire_codec_equals_the_jax_package():
    tm = _messages(tmsgs)
    for (_, t), (_, j), (_, tt) in zip(tm, _messages(jmsgs),
                                       _messages(tmsgs, image=torch.from_numpy)):
        wire = tremote._wire_encode(t)
        assert wire == jremote._wire_encode(j) == tremote._wire_encode(tt)
        back, jback = tremote._wire_decode(*wire), jremote._wire_decode(*wire)
        back = back[0] if isinstance(back, list) else back
        jback = jback[0] if isinstance(jback, list) else jback
        assert type(back).__name__ == type(jback).__name__ == type(t).__name__
        assert back.header == t.header
        for f in ("points", "position", "positions", "data", "translation"):
            if hasattr(t, f):
                np.testing.assert_array_equal(getattr(back, f), getattr(jback, f))


def test_bridged_buses_exchange_every_type():
    tm = _messages(tmsgs)
    with tremote.BusBroker() as broker:
        a, b = tcore.Bus(), tcore.Bus()
        ba = tremote.BusBridge(a, broker.address, name="A")
        bb = tremote.BusBridge(b, broker.address, name="B")
        assert broker.wait_for_clients(2, timeout=10)
        got = {}
        for topic, _ in tm:
            b.subscribe(topic, lambda m, t=topic: got.setdefault(t, m))
        for topic, msg in tm:
            a.publish(topic, msg)
        assert _wait(lambda: len(got) == len(tm), 10), sorted(got)
        np.testing.assert_array_equal(got["/pc"].points, tm[0][1].points)
        np.testing.assert_array_equal(got["/img"].data, tm[6][1].data)
        assert got["/tf"].child_frame_id == "X1"
        time.sleep(0.1)
        assert ba.n_sent == len(tm) and bb.n_sent == 0  # no echo loop
        ba.close()
        bb.close()


def test_port_and_jax_bridges_share_a_broker():
    with tremote.BusBroker(("127.0.0.1", 0)) as broker:
        a, b = tcore.Bus(), jcore.Bus()
        ba = tremote.BusBridge(a, broker.address, name="port")
        bb = jremote.BusBridge(b, broker.address, name="jax")
        assert broker.wait_for_clients(2, timeout=10)
        got, back = [], []
        b.subscribe("/path", got.append)
        a.subscribe("/pose", back.append)
        tm, jm = _messages(tmsgs), _messages(jmsgs)
        a.publish("/path", tm[2][1])
        b.publish("/pose", jm[1][1])
        assert _wait(lambda: got and back, 10)
        np.testing.assert_array_equal(got[0].positions, tm[2][1].positions)
        np.testing.assert_array_equal(back[0].position, jm[1][1].position)
        ba.close()
        bb.close()


def test_broker_reaps_a_dead_client_and_serves_it_again():
    with tremote.BusBroker() as broker:
        a, b, c = tcore.Bus(), tcore.Bus(), tcore.Bus()
        ba = tremote.BusBridge(a, broker.address, name="A")
        bb = tremote.BusBridge(b, broker.address, name="B")
        bc = tremote.BusBridge(c, broker.address, name="C")
        assert broker.wait_for_clients(3, timeout=10)
        got_b, got_c = [], []
        b.subscribe("/p", got_b.append)
        c.subscribe("/p", got_c.append)

        def send(stamp):
            a.publish("/p", tmsgs.PoseMsg(tmsgs.Header(stamp=stamp, frame_id="m"),
                                          [stamp, 0, 0], [0, 0, 0, 1]))

        send(1.0)
        assert _wait(lambda: got_b and got_c, 10)
        bc._sock.close()  # C dies abruptly, no goodbye
        for k in range(20):
            send(2.0 + k)
        assert _wait(lambda: len(got_b) >= 21, 10), len(got_b)
        assert _wait(lambda: broker.n_clients() == 2, 5)
        assert [m.header.stamp for m in got_b] == sorted(m.header.stamp for m in got_b)
        # C comes back on a fresh bridge and is served again
        bc2 = tremote.BusBridge(c, broker.address, name="C")
        assert broker.wait_for_clients(3, timeout=10)
        n_c = len(got_c)
        send(50.0)
        assert _wait(lambda: len(got_c) > n_c, 10)
        assert got_c[-1].header.stamp == 50.0
        for br in (ba, bb, bc2):
            br.close()


def _pair(cloud, path):
    hdr = tmsgs.Header(stamp=5.0, frame_id="map")
    q = np.tile([0.0, 0.0, 0.0, 1.0], (len(path), 1))
    return tmsgs.CloudMsg(hdr, cloud), tmsgs.PathMsg(hdr, path, q)


def test_node_process_returns_the_in_process_path():
    cfg = tlaunch.default_trajopt_config()
    cfg.opt_steps = 4
    cloud = load_point_cloud("data/points/point_cloud_10.npz")[::16]
    path = load_path("data/paths/path_poses_10.npz")
    pc, pm = _pair(cloud, path)

    bus = tcore.Bus()
    TrajOptNode(bus, cfg, device="cpu")
    local = []
    bus.subscribe(cfg.path_topic + "/optimized", local.append)
    bus.publish(cfg.pc_topic, pc)
    bus.publish(cfg.path_topic, pm)
    assert len(local) == 1

    broker = tremote.BusBroker().start()
    node = tremote.NodeProcess("TrajOptNode", cfg, broker.address, device="cpu",
                               env=ONE_THREAD)
    bus = tcore.Bus()
    bridge = tlaunch._attach_process_graph(bus, broker, [node], 2)
    remote = []
    try:
        bus.subscribe(cfg.path_topic + "/optimized", remote.append)
        bus.publish(cfg.pc_topic, pc)
        bus.publish(cfg.path_topic, pm)
        assert _wait(lambda: remote, 120.0, 0.1), "the worker published no path"
        assert node.alive()
    finally:
        tlaunch.Launch(bus, {"traj_opt": node}, [], broker=broker, bridge=bridge).close()
    assert not node.alive()
    np.testing.assert_array_equal(remote[0].positions, local[0].positions)
    np.testing.assert_array_equal(remote[0].orientations_xyzw, local[0].orientations_xyzw)


def test_a_worker_runs_torch_on_the_threads_its_env_sets(tmp_path):
    """The worker's module has loaded torch before the worker applies its
    ``env`` (the spawned process imports it to find the worker function),
    so the thread count is set on torch itself: without it the worker ran
    one OpenMP thread per core, which stalled the spawned TrajOptNode past
    its 120 s under a loaded test run."""
    log = tmp_path / "worker.log"
    broker = tremote.BusBroker().start()
    node = tremote.NodeProcess(
        "TrajOptNode", tlaunch.default_trajopt_config(), broker.address, device="cpu",
        env={"OMP_NUM_THREADS": "3", "MKL_NUM_THREADS": "3", "TRAJOPT_NODE_DEBUG": str(log)})
    try:
        assert _wait(lambda: log.exists() and "node built" in log.read_text(), 120.0, 0.1)
    finally:
        node.terminate()
        broker.close()
    assert "torch on 3 threads" in log.read_text(), log.read_text()


def test_a_worker_that_cannot_reach_its_device_fails_the_launch():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the worker would reach it")
    with pytest.raises(RuntimeError, match="died before attaching"):
        tlaunch.launch_trajectory_optimization(processes=True)  # device="cuda"
