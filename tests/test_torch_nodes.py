"""Parity of the port's optimizer nodes, feeders, voxel filter, time
synchronizer, messages and configs with the JAX twins, on the CPU.

Each node runs on its own bus beside the JAX node on another, fed the same
messages; the port's nodes take ``device="cpu"``. The optimizers run a few
Adam steps, so their outputs are held to stated tolerances; everything on
the host (pairing, configs, messages, feeders, the C++ voxel filter) must be
equal.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from trajectory_optimization_tpu.bus import core as jcore  # noqa: E402
from trajectory_optimization_tpu.bus import messages as jmsg  # noqa: E402
from trajectory_optimization_tpu.bus import nodes as jnodes  # noqa: E402
from trajectory_optimization_tpu.utils import config as jconfig  # noqa: E402
from trajectory_optimization_tpu_torch.bus import core as tcore  # noqa: E402
from trajectory_optimization_tpu_torch.bus import messages as tmsg  # noqa: E402
from trajectory_optimization_tpu_torch.bus import nodes as tnodes  # noqa: E402
from trajectory_optimization_tpu_torch.utils import config as tconfig  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import reference_data_dir  # noqa: E402

SIDES = ((jcore, jmsg, jnodes, jconfig, {}), (tcore, tmsg, tnodes, tconfig, {"device": "cpu"}))
CONFIGS = ("PoseOptNodeConfig", "TrajOptNodeConfig", "PointsProcessorConfig",
           "CloudFeederConfig", "PoseFeederConfig", "VoxelFilterConfig", "ViewerConfig")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (restored afterwards), as the other bit-comparing
    port tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_cloud(cloud10):
    """4,096 points of cloud 10, chosen by a seeded draw."""
    return cloud10[np.random.default_rng(7).choice(len(cloud10), 4096, replace=False)]


# ---- synchronizer, configs, messages ---------------------------------------

# (topic, stamp) in arrival order: out-of-order stamps, a pair outside the
# slop, a topic running ahead past the queue of 3, a tie in span
SCRIPT = [("/a", 1.0), ("/b", 1.2), ("/a", 3.0), ("/a", 2.0), ("/b", 2.1), ("/b", 5.0),
          ("/b", 5.2), ("/b", 5.4), ("/b", 5.6), ("/a", 5.5), ("/a", 9.0), ("/b", 9.6),
          ("/a", 9.55), ("/b", 9.5), ("/a", 12.0), ("/b", 11.75), ("/b", 12.25)]


@pytest.mark.parametrize("queue_size", [3, 10])
def test_synchronizer_fires_the_jax_pairs(queue_size):
    fired = []
    for core, msg, _, _, _ in SIDES:
        bus, got = core.Bus(error_policy="raise"), []
        core.ApproximateTimeSynchronizer(
            bus, ["/a", "/b"], lambda a, b: got.append((a.header.stamp, b.header.stamp)),
            queue_size=queue_size, slop=0.5)
        for topic, stamp in SCRIPT:
            bus.publish(topic, msg.CloudMsg(msg.Header(stamp=stamp), np.zeros((1, 3))))
        fired.append(got)
    assert fired[1] == fired[0]
    assert len(fired[1]) >= 5 and all(abs(a - b) <= 0.5 for a, b in fired[1])


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_and_overrides_match_jax(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert [(f.name, f.default) for f in dataclasses.fields(tcls)] == [
        (f.name, f.default) for f in dataclasses.fields(jcls)]
    # one override per field, of its type: tuples, Optionals, bools
    samples = {bool: ["true", "0"], int: ["7"], float: ["0.25"], str: ["/x"]}
    overrides = []
    for f in dataclasses.fields(tcls):
        default = f.default
        if f.name in ("z_limits",):
            overrides += [f"{f.name}=-1,5", f"{f.name}=none"]
        elif isinstance(default, tuple):
            overrides.append(f"{f.name}=/c0,/c1")
        elif default is None:
            overrides += [f"{f.name}=1.5", f"{f.name}=None"]
        else:
            overrides += [f"{f.name}={v}" for v in samples[type(default)]]
    for ov in overrides:
        for ovs in ([ov], [f"sec.{ov}"], [f"other.{ov}"]):
            want = jconfig.apply_overrides(jcls(), ovs, section="sec")
            got = tconfig.apply_overrides(tcls(), ovs, section="sec")
            assert dataclasses.asdict(got) == dataclasses.asdict(want), ovs
    for bad in (["no_such_key=1"], ["missing_equals"]):
        with pytest.raises(ValueError):
            jconfig.apply_overrides(jcls(), bad)
        with pytest.raises(ValueError):
            tconfig.apply_overrides(tcls(), bad)


def test_messages_match_jax(path10):
    a = tmsg.PathMsg.straight(path10, frame_id="map", stamp=2.0)
    b = jmsg.PathMsg.straight(path10, frame_id="map", stamp=2.0)
    for k in ("positions", "orientations_xyzw", "orientations_wxyz"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert getattr(a, k).dtype == getattr(b, k).dtype
    assert (a.header.stamp, a.header.frame_id) == (b.header.stamp, b.header.frame_id)
    pose = ([1.0, 2.0, 3.0], [0.1, 0.2, 0.3, 0.9])
    np.testing.assert_array_equal(tmsg.PoseMsg(tmsg.Header(0.0), *pose).orientation_wxyz,
                                  jmsg.PoseMsg(jmsg.Header(0.0), *pose).orientation_wxyz)
    img = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    for enc in ("bgr8", "bgra8", "rgb8", "mono8"):
        for x in (img, img[..., :3], img[..., 0]):
            np.testing.assert_array_equal(tmsg.bgr_to_rgb(x, enc), jmsg.bgr_to_rgb(x, enc))


# ---- the optimizer nodes ---------------------------------------------------

def _traj_nodes(steps, depth=1, rewards=True, **cfg):
    out = []
    for core, msg, nodes, config, kw in SIDES:
        bus = core.Bus(error_policy="raise")
        node = nodes.TrajOptNode(bus, config.TrajOptNodeConfig(
            pc_topic="/pc", path_topic="/path", opt_steps=steps, lr_pose=0.1, lr_quat=0.02,
            rewards_th=float("inf"), publish_rewards_cloud=rewards, pipeline_depth=depth, **cfg),
            **kw)
        got = {"path": [], "rewards": []}
        bus.subscribe("/path/optimized", got["path"].append)
        bus.subscribe("/pc/rewards", got["rewards"].append)
        out.append((bus, msg, node, got))
    return out


def test_traj_opt_node_matches_jax(small_cloud, path10):
    """5 steps. Measured: positions 3.8e-6 m apart (2.3e-6 on z components
    of 0.02-0.03 m), quaternions 1.8e-7, rewards 1.4e-6; held to rtol 1e-5
    with atol 1e-5 on positions and 1e-6 on the rest."""
    outs = []
    for bus, msg, node, got in _traj_nodes(5):
        bus.publish("/pc", msg.CloudMsg(msg.Header(stamp=1.0, frame_id="map"), small_cloud))
        bus.publish("/path", msg.PathMsg.straight(path10, frame_id="map", stamp=1.2))
        assert len(got["path"]) == len(got["rewards"]) == 1
        outs.append((got["path"][0], got["rewards"][0], node.last_result))
    (jp, jr, jres), (tp, tr, tres) = outs
    assert tp.header.frame_id == "map" and tp.positions.dtype == np.float64
    assert np.abs(tp.positions - path10).max() > 0.1  # the path moved
    np.testing.assert_allclose(tp.positions, jp.positions, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.orientations_xyzw, jp.orientations_xyzw, rtol=1e-5, atol=1e-6)
    assert tr.points.shape == jr.points.shape == (len(small_cloud), 4)
    np.testing.assert_array_equal(tr.points[:, :3], jr.points[:, :3])
    np.testing.assert_allclose(tr.points[:, 3], jr.points[:, 3], rtol=1e-5, atol=1e-6)
    assert tres["n_iters"] == jres["n_iters"] == 5
    np.testing.assert_allclose(tres["mean_reward"], jres["mean_reward"], rtol=1e-5)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-5)


def test_traj_opt_node_depth_2_publishes_depth_1s_messages(cloud10, path10):
    """pipeline_depth changes when results are published, never what."""
    runs = []
    for depth in (1, 2):
        bus, msg, node, got = _traj_nodes(4, depth=depth, rewards=False)[1]
        for i in range(3):
            bus.publish("/pc", msg.CloudMsg(msg.Header(stamp=10.0 * i, frame_id="map"),
                                            cloud10[:: 16 + i]))
            bus.publish("/path", msg.PathMsg.straight(path10, frame_id="map", stamp=10.0 * i))
            assert len(got["path"]) == i + 2 - depth  # lags by depth - 1
        node.flush()
        assert len(got["path"]) == 3 and not got["rewards"]
        runs.append(got["path"])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.orientations_xyzw, b.orientations_xyzw)


def _pose_run(cloud, steps, samples=4, **cfg):
    outs = []
    for core, msg, nodes, config, kw in SIDES:
        bus = core.Bus(error_policy="raise")
        node = nodes.PoseOptNode(bus, config.PoseOptNodeConfig(
            pc_topic="/pts", pose_topic="/pose", opt_steps=steps, lr_pose=0.02, lr_quat=0.02,
            num_pub_samples=samples, **cfg), **kw)
        order = []
        for topic in ("/odom", "/tf", "/camera/camera_info", "/pts/rewards"):
            bus.subscribe(topic, lambda m, t=topic: order.append((t, m)))
        bus.publish("/pts", msg.CloudMsg(msg.Header(stamp=5.0, frame_id="world"), cloud))
        bus.publish("/pose", msg.PoseMsg(msg.Header(stamp=5.1, frame_id="world"),
                                         [6.0, 2.0, 0.0], [0.1, -0.3, 0.2, 0.9]))
        outs.append((order, node))
    return outs


def test_pose_opt_node_matches_jax(cloud10):
    """23 steps in segments of 5 and a remainder of 3: five publishes of
    /odom, /tf, /camera/camera_info and the rewards cloud, in the JAX
    node's order. Measured: positions 1.5e-8 m, quaternions 4.1e-7,
    observations 9.2e-7 apart; held to rtol 1e-5, atol 1e-6 and the forward
    pin."""
    (jorder, jnode), (torder, tnode) = _pose_run(cloud10[::8], 23)
    assert [t for t, _ in torder] == [t for t, _ in jorder]
    assert [t for t, _ in torder].count("/odom") == 5
    for (t, a), (_, b) in zip(torder, jorder):
        if t == "/odom":
            np.testing.assert_allclose(a.position, b.position, rtol=1e-5)
            np.testing.assert_allclose(a.orientation_xyzw, b.orientation_xyzw, atol=1e-6)
        elif t == "/camera/camera_info":
            assert (a.K, a.D, a.width, a.height) == (b.K, b.D, b.width, b.height)
        elif t == "/pts/rewards":
            np.testing.assert_allclose(a.points, b.points, rtol=1e-4, atol=2e-4)
    assert tnode.last_result["n_iters"] == jnode.last_result["n_iters"] == 23
    np.testing.assert_allclose(tnode.last_result["loss"], jnode.last_result["loss"], rtol=1e-5)
    tt, tq = tnode.frames.lookup("world", "camera_frame")
    np.testing.assert_allclose(tt, jnode.frames.lookup("world", "camera_frame")[0], rtol=1e-5)


def test_pose_opt_node_zero_steps(cloud10):
    """tests/test_nodes.py:127's case: nothing published, loss inf."""
    for order, node in _pose_run(cloud10[::64], 0):
        assert order == [] and node.last_result == {"loss": float("inf"), "n_iters": 0}


def test_hpr_options_raise(cloud10, path10):
    """The HPR options, once raising here, run and match the JAX nodes.
    TrajOptNode(use_soft_hpr=True): 2 steps on cloud 10 cut to 2,023 points
    at vis_wps_dist 2 (4 selected waypoints), its path and rewards against
    the JAX node's. PoseOptNode(use_hpr=True) and (use_soft_hpr=True): 3
    steps in segments of 1, every /odom against the JAX node's. Soft HPR's
    gradients differ from the JAX ones by ~1e-3 relative (f32 rounding
    through its sharp sigmoid, tests/test_torch_hpr.py): poses held to 1e-4
    after these few steps."""
    pts = cloud10[::20]
    outs = []
    for bus, msg, node, got in _traj_nodes(2, use_soft_hpr=True, vis_wps_dist=2.0):
        bus.publish("/pc", msg.CloudMsg(msg.Header(stamp=1.0, frame_id="map"), pts))
        bus.publish("/path", msg.PathMsg.straight(path10, frame_id="map", stamp=1.2))
        assert len(got["path"]) == len(got["rewards"]) == 1
        outs.append((got["path"][0], got["rewards"][0], node.last_result))
    (jp, jr, jres), (tp, tr, tres) = outs
    assert np.abs(tp.positions - path10).max() > 0.1  # the path moved
    np.testing.assert_allclose(tp.positions, jp.positions, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tp.orientations_xyzw, jp.orientations_xyzw, atol=1e-4)
    # a reward moves with its gated scores: the soft mask's f32 spread
    # (under 5e-3, tests/test_torch_hpr.py) bounds it
    np.testing.assert_allclose(tr.points[:, 3], jr.points[:, 3], rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-4)
    for cfg in ({"use_hpr": True}, {"use_soft_hpr": True}):
        (jorder, jnode), (torder, tnode) = _pose_run(cloud10[::12], 3, samples=3, **cfg)
        assert [t for t, _ in torder] == [t for t, _ in jorder]
        odoms = [(a, b) for (t, a), (_, b) in zip(torder, jorder) if t == "/odom"]
        assert len(odoms) == 3
        for a, b in odoms:
            np.testing.assert_allclose(a.position, b.position, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(a.orientation_xyzw, b.orientation_xyzw, atol=1e-4)
        np.testing.assert_allclose(tnode.last_result["loss"], jnode.last_result["loss"],
                                   rtol=1e-4)


# ---- feeders and the voxel filter ------------------------------------------

def test_feeders_publish_the_jax_messages():
    data_dir = str(reference_data_dir() + "/points")
    got = []
    for core, msg, nodes, config, _ in SIDES:
        bus, seen = core.Bus(error_policy="raise"), []
        bus.subscribe("/pts", seen.append)
        bus.subscribe("/pose", seen.append)
        nodes.CloudFeederNode(bus, config.CloudFeederConfig(data_dir=data_dir)).tick()
        fixed = config.PoseFeederConfig(x=6.0, y=2.0, z=0.0, roll=0.0, pitch=0.0, yaw=0.3)
        nodes.PoseFeederNode(bus, fixed).tick()
        nodes.PoseFeederNode(bus, config.PoseFeederConfig(),
                             rng=np.random.default_rng(11)).tick()
        got.append(seen)
    (jc, jf, jr), (tc, tf, tr) = got
    np.testing.assert_array_equal(tc.points, jc.points)
    assert tc.points.shape == (40452, 3) and tc.header.frame_id == jc.header.frame_id
    for a, b in ((tf, jf), (tr, jr)):
        np.testing.assert_array_equal(a.position, b.position)
        np.testing.assert_array_equal(a.orientation_xyzw, b.orientation_xyzw)


@pytest.mark.parametrize("z_limits", [None, (-1.0, 1.5)])
def test_voxel_filter_node_matches_jax(cloud10, z_limits):
    outs = []
    for core, msg, nodes, config, _ in SIDES:
        bus, seen = core.Bus(error_policy="raise"), []
        nodes.VoxelFilterNode(bus, config.VoxelFilterConfig(
            input_topic="/in", output_topic="/out", leaf_size=0.3, z_limits=z_limits))
        bus.subscribe("/out", seen.append)
        bus.publish("/in", msg.CloudMsg(msg.Header(stamp=3.0, frame_id="map"), cloud10))
        outs.append(seen[0])
    j, t = outs
    assert t.header.stamp == 3.0 and t.header.frame_id == "map"
    assert 1000 < len(t.points) < len(cloud10)

    def key(x):
        return x[np.lexsort((x[:, 2], x[:, 1], x[:, 0]))]

    np.testing.assert_array_equal(key(t.points), key(j.points))
