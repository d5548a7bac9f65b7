"""The port's ``PointsProcessorNode(device="cpu")`` against the JAX node,
with ``hpr_backend="none"`` on cloud 10 and with ``"exact"`` and ``"approx"``
on every fourth point of it, on the six-camera ring of
tests/test_nodes.py:198-203; and the port's ``FrameGraph`` copy against the
JAX one on the cases of tests/test_bus.py the node's path uses."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_tpu.bus import core as jcore  # noqa: E402
from trajectory_optimization_tpu.bus import frames as jframes  # noqa: E402
from trajectory_optimization_tpu.bus import messages as jmsg  # noqa: E402
from trajectory_optimization_tpu.bus import nodes as jnodes  # noqa: E402
from trajectory_optimization_tpu.ops.pallas_render import render_point_cloud_pallas  # noqa: E402
from trajectory_optimization_tpu.utils import config as jconfig  # noqa: E402
from trajectory_optimization_tpu.utils.data import pad_points  # noqa: E402
from trajectory_optimization_tpu_torch.bus import core as tcore  # noqa: E402
from trajectory_optimization_tpu_torch.bus import frames as tframes  # noqa: E402
from trajectory_optimization_tpu_torch.bus import messages as tmsg  # noqa: E402
from trajectory_optimization_tpu_torch.bus import nodes as tnodes  # noqa: E402
from trajectory_optimization_tpu_torch.utils import config as tconfig  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

CAMS = [f"cam{i}" for i in range(6)]
INTR = default_intrinsics()
REF_K = (tuple(INTR.matrix_np(np.float64).reshape(-1)), int(INTR.width), int(INTR.height))
SMALL_K = ((100.0, 0.0, 64.0, 0.0, 100.0, 48.0, 0.0, 0.0, 1.0), 128, 96)  # test_pallas_render's K
PIN = 1e-3  # share of pixels that may differ by more than 1e-3 (z-ties)


def _nodes(cams, render, topics=(), hpr="none"):
    """A JAX node and a port node on their own buses, both seeing the ring."""
    out = []
    for core, config, nodes, kw in (
        (jcore, jconfig, jnodes, {}),
        (tcore, tconfig, tnodes, {"device": "cpu"}),
    ):
        bus = core.Bus(error_policy="raise")
        node = nodes.PointsProcessorNode(
            bus, config.PointsProcessorConfig(pc_topic="/cloud", cam_info_topics=topics,
                                              hpr_backend=hpr, render=render), **kw)
        for i, c in enumerate(cams):
            a = 2 * np.pi * i / 6
            node.frames.set_transform("world", c, [6 + 3 * np.cos(a), 2 + 3 * np.sin(a), -2.0],
                                      [0, 0, 0, 1])
        out.append(node)
    return out


def _infos(msg, cams, k):
    K, w, h = k
    return [msg.CameraInfoMsg(msg.Header(stamp=0.0, frame_id=c), w, h, K=K) for c in cams]


def _cloud(msg, pts):
    return msg.CloudMsg(msg.Header(stamp=0.0, frame_id="world"), pts)


def test_rig_cull_matches_jax_node(cloud10):
    jn, tn = _nodes(CAMS, render=False)
    jout = jn.process_all(_cloud(jmsg, cloud10), _infos(jmsg, CAMS, REF_K))
    tout = tn.process_all(_cloud(tmsg, cloud10), _infos(tmsg, CAMS, REF_K))
    assert list(tout) == CAMS
    for c, tinfo, jinfo in zip(CAMS, _infos(tmsg, CAMS, REF_K), _infos(jmsg, CAMS, REF_K)):
        np.testing.assert_array_equal(tout[c], jout[c])  # batched: culled = visible
        assert 0 < len(tout[c]) < len(cloud10)
        serial = tn.process(_cloud(tmsg, cloud10), tinfo)
        np.testing.assert_array_equal(serial, jn.process(_cloud(jmsg, cloud10), jinfo))
        # the batched f32 device transform and the serial f64 host transform
        assert abs(len(serial) - len(tout[c])) <= max(3, 0.01 * len(tout[c]))


def test_rig_images_match_jax_node_over_the_bus(cloud10):
    """Six CameraInfo topics sharing intrinsics: one batched evaluation per
    cloud; each published image against the JAX node's (its XLA renderer on
    the CPU) to the 0.1% pin, on a small camera."""
    cams = CAMS[:3]
    topics = tuple(f"/{c}/info" for c in cams)
    jn, tn = _nodes(cams, render=True, topics=topics)
    got = {}
    for node, msg, host in ((jn, jmsg, np.asarray), (tn, tmsg, lambda d: d.numpy())):
        seen = got.setdefault(msg, {})
        for c in cams:
            for suffix in ("pointcloud", "pointcloud_visible", "pointcloud_image"):
                node.bus.subscribe(f"/{c}/{suffix}",
                                   lambda m, k=(c, suffix), h=host, s=seen: s.__setitem__(
                                       k, h(m.data) if k[1].endswith("image") else m.points))
        node.bus.publish("/cloud", _cloud(msg, cloud10))
        for c, info in zip(cams, _infos(msg, cams, SMALL_K)):
            node.bus.publish(f"/{c}/info", info)
        assert node.n_batched == 1 and node.n_serial == 0
    j, t = got[jmsg], got[tmsg]
    assert set(t) == set(j) and len(t) == 3 * len(cams)
    for key, value in t.items():
        if key[1].endswith("image"):
            assert value.shape == (96, 128, 3) and value.dtype == np.float32
            n = int((np.abs(value - j[key]).max(axis=2) > 1e-3).sum())
            assert n < PIN * 96 * 128, f"{key}: {n} pixels differ"
            assert (value < 1).any()
        else:
            np.testing.assert_array_equal(value, j[key])
    assert "render_dropped_splats" not in tn.metrics.snapshot()  # run path: exact


def test_dense_path_counts_dropped_splats_as_jax(cloud10):
    """A visible set padded above 65,536 takes the dense path; the node
    reports the splats its per-tile cap dropped, as the Pallas twin counts
    them on the same padded points."""
    rng = np.random.default_rng(0)
    z = rng.uniform(2, 14, 66000)  # inside cam0's small frustum, which faces world +z
    front = np.stack([z * rng.uniform(-0.6, 0.6, z.size), z * rng.uniform(-0.45, 0.45, z.size), z], 1)
    pts = np.concatenate([cloud10, front + [9.0, 2.0, -2.0]]).astype(np.float32)
    _, tn = _nodes(CAMS[:1], render=True)
    images = []
    tn.bus.subscribe("/cam0/pointcloud_image", lambda m: images.append(m.data))
    visible = tn.process(_cloud(tmsg, pts), _infos(tmsg, CAMS[:1], SMALL_K)[0])
    padded, valid = pad_points(visible)
    assert len(padded) > 65536
    jimg, jdropped = render_point_cloud_pallas(
        jnp.asarray(padded), jnp.asarray(np.reshape(SMALL_K[0], (3, 3)), jnp.float32), 96, 128,
        znear=1.0, zfar=15.0, valid=jnp.asarray(valid), return_overflow=True)
    assert int(jdropped) > 0
    assert tn.metrics.snapshot()["render_dropped_splats"] == float(jdropped)
    np.testing.assert_array_equal(images[0].numpy(), np.asarray(jimg))


def _rows(a):
    return {tuple(r) for r in np.asarray(a, np.float32).tolist()}


@pytest.mark.parametrize("backend", ["approx", "exact"])
def test_unported_hpr_backends_raise(cloud10, backend):
    """Both HPR backends, once raising here, now run: over the bus (one
    batched rig per cloud, and for "approx" one batched pursuit) and through
    ``process``, on every fourth point of cloud 10. "exact" publishes the
    JAX node's visible clouds; "approx" differs from them on under 1% of each
    camera's culled points, and hides every point Qhull hides."""
    pts = cloud10[::4]
    topics = tuple(f"/{c}/info" for c in CAMS)
    jn, tn = _nodes(CAMS, render=False, topics=topics, hpr=backend)
    got = {}
    for node, msg in ((jn, jmsg), (tn, tmsg)):
        seen = got.setdefault(msg, {})
        for c in CAMS:
            for suffix in ("pointcloud", "pointcloud_visible"):
                node.bus.subscribe(f"/{c}/{suffix}", lambda m, k=(c, suffix), s=seen:
                                   s.__setitem__(k, m.points))
        node.bus.publish("/cloud", _cloud(msg, pts))
        for c, info in zip(CAMS, _infos(msg, CAMS, REF_K)):
            node.bus.publish(f"/{c}/info", info)
        assert node.n_batched == 1
    j, t = got[jmsg], got[tmsg]
    serial = (tn.process(_cloud(tmsg, pts), _infos(tmsg, CAMS, REF_K)[0]),
              jn.process(_cloud(jmsg, pts), _infos(jmsg, CAMS, REF_K)[0]))
    for c in CAMS:
        culled = t[(c, "pointcloud")]
        np.testing.assert_array_equal(culled, j[(c, "pointcloud")])
        vis_t, vis_j = t[(c, "pointcloud_visible")], j[(c, "pointcloud_visible")]
        assert 0 < len(vis_t) < len(culled)
        if backend == "exact":
            np.testing.assert_array_equal(vis_t, vis_j)
        else:
            assert len(_rows(vis_t) ^ _rows(vis_j)) < 0.01 * len(culled)
            assert _rows(vis_t) <= _rows(tnodes.hpr_points_exact(culled)[0])
    if backend == "exact":
        np.testing.assert_array_equal(*serial)
    else:
        assert len(_rows(serial[0]) ^ _rows(serial[1])) < 0.01 * len(t[("cam0", "pointcloud")])


def test_camera_info_intrinsics_match_jax():
    K, w, h = REF_K
    a = tmsg.CameraInfoMsg(tmsg.Header(stamp=0.0, frame_id="cam0"), w, h, K=K).intrinsics()
    b = jmsg.CameraInfoMsg(jmsg.Header(stamp=0.0, frame_id="cam0"), w, h, K=K).intrinsics()
    np.testing.assert_array_equal(a.matrix_np(np.float64), b.matrix_np(np.float64))
    assert (a.width, a.height, a.frame_id) == (b.width, b.height, b.frame_id)


# ---- FrameGraph, against the JAX copy (float64, exact) ---------------------

QI = [0, 0, 0, 1]
QZ90 = [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]


def _graphs(edges):
    out = []
    for mod in (jframes, tframes):
        fg = mod.FrameGraph()
        for parent, child, t, q, stamp in edges:
            fg.set_transform(parent, child, t, q, stamp=stamp)
        out.append(fg)
    return out


def _same(jfg, tfg, *args, **kw):
    for name in ("lookup", "lookup_matrix"):
        a, b = getattr(jfg, name)(*args, **kw), getattr(tfg, name)(*args, **kw)
        for x, y in zip(np.atleast_1d(a) if name == "lookup_matrix" else a,
                        np.atleast_1d(b) if name == "lookup_matrix" else b):
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("time", [0.0, 1.5, 2.0, -5.0, None])
def test_frame_graph_time_indexed_lookup_matches_jax(time):
    jfg, tfg = _graphs([("map", "base", [2.0 * s, 0, 0], QI, float(s)) for s in range(3)])
    _same(jfg, tfg, "map", "base", time=time)


def test_frame_graph_slerp_and_roundtrip_match_jax():
    jfg, tfg = _graphs([("map", "base", [0, 0, 0], QI, 0.0), ("map", "base", [0, 0, 0], QZ90, 1.0),
                        ("base", "cam", [0, 1, 0], QZ90, 0.0)])
    pts = np.random.default_rng(0).normal(size=(16, 3))
    for t in (0.0, 0.5, None):
        _same(jfg, tfg, "cam", "map", time=t)
        np.testing.assert_array_equal(tfg.transform_points(pts, "map", "cam", time=t),
                                      jfg.transform_points(pts, "map", "cam", time=t))
    np.testing.assert_allclose(tfg.transform_points(np.zeros((1, 3)), "base", "cam"), [[0, 1, 0]])


def test_frame_graph_listens_and_errors_as_jax():
    graphs = []
    for mod, core, msg in ((jframes, jcore, jmsg), (tframes, tcore, tmsg)):
        bus, fg = core.Bus(), mod.FrameGraph()
        fg.listen(bus)
        bus.publish("/tf_static", msg.TransformMsg(msg.Header(stamp=99.0, frame_id="base"), "cam",
                                                   [0.0, 0.5, 0.0], QI))
        for stamp, x in [(0.0, 0.0), (1.0, 2.0)]:
            bus.publish("/tf", msg.TransformMsg(msg.Header(stamp=stamp, frame_id="map"), "base",
                                                [x, 0.0, 0.0], QI))
        fg.set_transform("a", "b", [0, 0, 0], QI)
        graphs.append(fg)
        with pytest.raises(KeyError):
            fg.lookup("map", "z")
        with pytest.raises(KeyError):
            fg.lookup("map", "b")  # disconnected components
    _same(*graphs, "map", "cam", time=0.5)
    np.testing.assert_allclose(graphs[1].lookup("map", "cam", time=0.0)[0], [0.0, 0.5, 0.0],
                               atol=1e-9)
