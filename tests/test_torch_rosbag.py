"""The port's bag I/O against the JAX package: ``bus/{rosbag,replay,
dataset}.py`` and ``messages.host_image``.

Held, byte for byte or ``assert_array_equal``: the same message list
written by both packages gives identical bags under compression none, bz2
and lz4, and reads back to equal messages; both golden bags of
``tests/data/rosbag_golden/`` read to equal messages and the same
``bag_info(...).format()`` text; ``filter_bag`` outputs are identical;
``BagRecorder`` with split size and split duration writes the same files;
``open_player`` on a bag and on an npz recording and the npz ``replay``
publish the same sequences; ``extract_dataset`` writes the same npz and PNG
files; an ``ImageMsg`` whose ``data`` is a tensor records the same bag as
its numpy twin (the host copy that a CUDA payload takes, on a CPU tensor
here; the card's side is ``chip_smoke.py`` [cli]).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from trajectory_optimization_tpu.bus import core as jcore  # noqa: E402
from trajectory_optimization_tpu.bus import dataset as jdataset  # noqa: E402
from trajectory_optimization_tpu.bus import messages as jmsgs  # noqa: E402
from trajectory_optimization_tpu.bus import replay as jreplay  # noqa: E402
from trajectory_optimization_tpu.bus import rosbag as jbag  # noqa: E402
from trajectory_optimization_tpu_torch.bus import core as tcore  # noqa: E402
from trajectory_optimization_tpu_torch.bus import dataset as tdataset  # noqa: E402
from trajectory_optimization_tpu_torch.bus import messages as tmsgs  # noqa: E402
from trajectory_optimization_tpu_torch.bus import replay as treplay  # noqa: E402
from trajectory_optimization_tpu_torch.bus import rosbag as tbag  # noqa: E402
from trajectory_optimization_tpu_torch.bus.jpeg import encode_jpeg  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "rosbag_golden")
COMPRESSIONS = ["none", "bz2", "lz4"]


def _arrays(n):
    rng = np.random.default_rng(0)
    return [dict(cloud=rng.normal(size=(300, 4)).astype(np.float32),
                 path=rng.normal(size=(7, 3)),
                 pos=rng.normal(size=3), quat=np.array([0.0, 0.0, 0.6, 0.8]),
                 rgb=rng.integers(0, 255, size=(24, 32, 3), dtype=np.uint8),
                 gray=rng.integers(0, 255, size=(24, 32), dtype=np.uint8))
            for _ in range(n)]


def _messages(M, n=4, image=lambda a: a):
    """A seeded session of every bag message type on the module ``M``'s
    classes; ``image`` wraps each raw image payload."""
    jpeg = encode_jpeg(_arrays(1)[0]["rgb"], quality=80)
    out = []
    for i, a in enumerate(_arrays(n)):
        t = 100.0 + 0.4 * i

        def H(fid, dt=0.0):
            return M.Header(stamp=t + dt, frame_id=fid, seq=i)

        ident = np.tile([0.0, 0.0, 0.0, 1.0], (len(a["path"]), 1))
        out += [
            ("/pts", M.CloudMsg(H("map"), a["cloud"])),
            ("/pose", M.PoseMsg(H("map", 0.01), a["pos"], a["quat"])),
            ("/path", M.PathMsg(H("map", 0.02), a["path"], ident)),
            ("/odom", M.OdometryMsg(H("odom", 0.03), a["pos"], a["quat"], child_frame_id="base")),
            ("/cam0/info", M.CameraInfoMsg(H("cam0", 0.04), 32, 24,
                                           K=(30.0, 0.0, 16.0, 0.0, 31.0, 12.0, 0.0, 0.0, 1.0))),
            ("/cam0/image", M.ImageMsg(H("cam0", 0.05), image(a["rgb"]), encoding="rgb8")),
            ("/cam1/image", M.ImageMsg(H("cam1", 0.06), image(a["rgb"]), encoding="bgr8",
                                       wire_format="png")),
            ("/cam2/image", M.ImageMsg(H("cam2", 0.07), image(a["gray"]), encoding="mono8")),
            ("/cam3/image/compressed", M.ImageMsg(H("cam3", 0.08), image(a["rgb"]),
                                                  encoding="rgb8", wire_format="jpeg")),
            ("/cam4/image/compressed", M.ImageMsg(H("cam4", 0.09),
                                                  np.frombuffer(jpeg, np.uint8).copy(),
                                                  encoding="jpeg")),
            ("/tf", M.TransformMsg(H("map", 0.1), "base", a["pos"], a["quat"])),
        ]
    return out


def _norm(msg):
    """A message as plain comparable values: type name, header, fields (an
    array as dtype, shape and bytes)."""
    if isinstance(msg, list):
        return [_norm(m) for m in msg]
    out = [type(msg).__name__]
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        if f.name == "header":
            v = (v.stamp, v.frame_id, v.seq)
        elif isinstance(v, torch.Tensor):
            v = v.numpy()
        if isinstance(v, np.ndarray):
            v = (str(v.dtype), v.shape, v.tobytes())
        out.append((f.name, tuple(v) if isinstance(v, list) else v))
    return out


def _read(bag, path, **kw):
    return [(t, topic, _norm(m)) for t, topic, m in bag.read_bag(path, **kw)]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_written_bags_are_identical(tmp_path, compression):
    t_path, j_path = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    n = tbag.write_bag(t_path, _messages(tmsgs), compression=compression)
    assert n == jbag.write_bag(j_path, _messages(jmsgs), compression=compression) == 44
    assert _bytes(t_path) == _bytes(j_path)
    assert _read(tbag, t_path) == _read(jbag, j_path)
    assert tbag.bag_info(t_path).format() == jbag.bag_info(t_path).format()
    topics = ["/tf", "/cam3/image/compressed"]
    assert _read(tbag, t_path, topics=topics) == _read(jbag, j_path, topics=topics)


@pytest.mark.parametrize("name", ["golden_indexed.bag", "golden_truncated.bag"])
def test_golden_bags_read_equal(name):
    path = os.path.join(GOLDEN, name)
    events = _read(tbag, path)
    assert events and events == _read(jbag, path)
    assert tbag.bag_info(path).format() == jbag.bag_info(path).format()


@pytest.mark.parametrize("kw", [dict(topics=["/pts", "/tf"]), dict(start=100.5, end=101.1),
                                dict(compression="lz4"), dict(topics=["/cam4/image/compressed"],
                                                              compression="bz2")])
def test_filter_bag_outputs_are_identical(tmp_path, kw):
    src = str(tmp_path / "src.bag")
    jbag.write_bag(src, _messages(jmsgs), compression="bz2")
    t_dst, j_dst = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    assert tbag.filter_bag(src, t_dst, **kw) == jbag.filter_bag(src, j_dst, **kw) > 0
    assert _bytes(t_dst) == _bytes(j_dst)


def _record(bag, core, M, out, **kw):
    bus = core.Bus()
    rec = bag.BagRecorder(bus, None, out, **kw)
    for topic, msg in _messages(M):
        bus.publish(topic, msg)
    rec.close()
    return rec


@pytest.mark.parametrize("kw", [dict(split_size=40_000), dict(split_duration=0.5),
                                dict(split_size=60_000, compression="lz4"),
                                dict(compression="bz2")])
def test_bag_recorder_writes_the_same_files(tmp_path, kw):
    os.makedirs(tmp_path / "t"), os.makedirs(tmp_path / "j")
    t = _record(tbag, tcore, tmsgs, str(tmp_path / "t" / "rec.bag"), **kw)
    j = _record(jbag, jcore, jmsgs, str(tmp_path / "j" / "rec.bag"), **kw)
    assert (t.count, t.skipped) == (j.count, j.skipped) == (44, 0)
    assert [os.path.basename(p) for p in t.paths] == [os.path.basename(p) for p in j.paths]
    assert len(t.paths) > 1 or "split_size" not in kw and "split_duration" not in kw
    for a, b in zip(t.paths, j.paths):
        assert _bytes(a) == _bytes(b)


def test_tensor_images_record_as_their_numpy_twins(tmp_path):
    """The host copy a CUDA payload takes (``host_image``: ``.cpu()``, then
    numpy), on CPU tensors: the bag equals the numpy recording's and the
    JAX package's, and the npz recorder's files hold the same arrays."""
    as_tensor = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    paths = [str(tmp_path / f"{k}.bag") for k in ("tensor", "numpy", "jax")]
    tbag.write_bag(paths[0], _messages(tmsgs, image=as_tensor))
    tbag.write_bag(paths[1], _messages(tmsgs))
    jbag.write_bag(paths[2], _messages(jmsgs))
    assert _bytes(paths[0]) == _bytes(paths[1]) == _bytes(paths[2])
    np.testing.assert_array_equal(tmsgs.host_image(as_tensor(_arrays(1)[0]["rgb"])),
                                  _arrays(1)[0]["rgb"])
    bus = tcore.Bus()
    with treplay.Recorder(bus, ["/cam0/image"], str(tmp_path / "npz")):
        for topic, msg in _messages(tmsgs, image=as_tensor):
            bus.publish(topic, msg)
    played = [_norm(m) for _, m in treplay.Player(str(tmp_path / "npz")).messages()]
    assert played == [_norm(m) for t, m in _messages(tmsgs) if t == "/cam0/image"]


def _played(player, core):
    bus, seen = core.Bus(), []
    bus.add_tap(lambda topic, msg: seen.append((topic, _norm(msg))))
    n = player.play(bus)
    return n, seen


@pytest.mark.parametrize("streaming", [False, True])
def test_players_publish_the_same_sequence(tmp_path, streaming):
    path = str(tmp_path / "s.bag")
    jbag.write_bag(path, _messages(jmsgs), compression="lz4")
    t = _played(tbag.open_player(path, streaming=streaming), tcore)
    j = _played(jbag.open_player(path, streaming=streaming), jcore)
    assert t == j and t[0] == 44
    # the npz recording: each package records its own session and replays it
    for bag, core, replay, M, d in ((tbag, tcore, treplay, tmsgs, "t"),
                                    (jbag, jcore, jreplay, jmsgs, "j")):
        bus = core.Bus()
        with replay.Recorder(bus, ["/pts", "/path", "/cam0/image", "/tf"], str(tmp_path / d)):
            for topic, msg in _messages(M):
                bus.publish(topic, msg)
    t = _played(tbag.open_player(str(tmp_path / "t")), tcore)
    assert t == _played(jbag.open_player(str(tmp_path / "j")), jcore) and t[0] == 16
    window = dict(start=0.3, duration=0.5)
    assert ([(tp, _norm(m)) for tp, m in treplay.Player(str(tmp_path / "t")).messages(**window)]
            == [(tp, _norm(m)) for tp, m in jreplay.Player(str(tmp_path / "j")).messages(**window)])


def test_extract_dataset_writes_the_same_files(tmp_path):
    src = str(tmp_path / "s.bag")
    msgs = [(("/final_cost_cloud" if t == "/pts" else t), m) for t, m in _messages(jmsgs)]
    jbag.write_bag(src, msgs)
    kw = dict(image_topics=["/cam0/image", "/cam1/image", "/cam4/image/compressed"],
              camera_info_topics=["/cam0/info"])
    res = {}
    for name, ds in (("t", tdataset), ("j", jdataset)):
        res[name] = ds.extract_dataset(src, str(tmp_path / name), **kw)
        assert res[name].n_files == 4 + 4 + 12 + 1
    assert res["t"].skipped_images == res["j"].skipped_images
    files = {name: sorted(os.path.relpath(os.path.join(r, f), tmp_path / name)
                          for r, _, fs in os.walk(tmp_path / name) for f in fs)
             for name in ("t", "j")}
    assert files["t"] == files["j"]
    for rel in files["t"]:
        a, b = tmp_path / "t" / rel, tmp_path / "j" / rel
        if rel.endswith(".png"):
            assert _bytes(a) == _bytes(b)
        else:
            with np.load(a) as x, np.load(b) as y:
                assert x.files == y.files
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k])
    one = tdataset.extract_dataset(src, str(tmp_path / "one"), indices=[2])
    assert [os.path.basename(p) for p in one.clouds] == ["point_cloud_2.npz"]
