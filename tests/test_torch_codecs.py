"""The port's copied codecs against the JAX package: ``bus/{lz4,png,jpeg,
gif,codec}.py`` and the codec entry points of the port's ``native/``.

Held, with the native library and with its numpy fallback (``native._load``
patched to None in both packages): lz4 frames, PNG, JPEG (4:4:4, 4:2:0,
gray) and GIF encodes byte-equal to the JAX package's on seeded inputs;
decodes ``assert_array_equal`` to JAX's and to the committed oracles of
``tests/data/imgcodec/``; the native entry points equal to the numpy
paths; the PointCloud2 wire codec's records and round trips equal to JAX's.
Integer codecs: no tolerance anywhere.

The JAX package's loader builds its library in place with ``make`` when the
file is missing or stale, and caches a failed load (``_tried``) for the life
of the process. Test files of both packages that load it can start that build
at the same moment in parallel workers, and a worker that opens the file while
another writes it is left on the numpy fallback. ``_load_jax_native`` retries
under a lock until the library loads, so that "native" compares the two C++
libraries and not one library with the other package's numpy.

The JAX package's own two JPEG encoders disagree at (40, 56, 3), quality 75,
4:2:0 (956 bytes with its library, 957 with its numpy fallback): the port
copied both, and ``test_jpeg_reference_encoders_disagree_by_one_byte`` pins
that the port reproduces each of them there.
"""
import fcntl
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import trajectory_optimization_tpu.native as jnative  # noqa: E402
import trajectory_optimization_tpu_torch.native as tnative  # noqa: E402
from trajectory_optimization_tpu.bus import codec as jcodec  # noqa: E402
from trajectory_optimization_tpu.bus import gif as jgif  # noqa: E402
from trajectory_optimization_tpu.bus import jpeg as jjpeg  # noqa: E402
from trajectory_optimization_tpu.bus import lz4 as jlz4  # noqa: E402
from trajectory_optimization_tpu.bus import png as jpng  # noqa: E402
from trajectory_optimization_tpu.bus.messages import Header as JHeader  # noqa: E402
from trajectory_optimization_tpu_torch.bus import codec as tcodec  # noqa: E402
from trajectory_optimization_tpu_torch.bus import gif as tgif  # noqa: E402
from trajectory_optimization_tpu_torch.bus import jpeg as tjpeg  # noqa: E402
from trajectory_optimization_tpu_torch.bus import lz4 as tlz4  # noqa: E402
from trajectory_optimization_tpu_torch.bus import png as tpng  # noqa: E402
from trajectory_optimization_tpu_torch.bus.messages import Header as THeader  # noqa: E402

FIXDIR = os.path.join(os.path.dirname(__file__), "data", "imgcodec")
LOCK = os.path.join(os.path.dirname(__file__), "..", "build", "jax_native_load.lock")
JPEGS = ["rgb_q85_420.jpg", "rgb_q90_444.jpg", "rgb_q75_422.jpg", "gray_q90.jpg",
         "rgb_rst.jpg", "progressive.jpg"]
PNGS = ["rgb.png", "depth16.png"]


def _load_jax_native(monkeypatch, timeout=180.0):
    """Load the JAX package's native library, waiting out a build that a
    parallel worker runs: retry under a file lock, clearing the loader's
    cached failure (``_tried``) before each try, until it loads. Fails the
    test if it does not within ``timeout`` seconds."""
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    deadline = time.monotonic() + timeout
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        while jnative._load() is None:
            if time.monotonic() > deadline:
                pytest.fail("the JAX package's native library did not load")
            time.sleep(0.5)
            monkeypatch.setattr(jnative, "_tried", False)


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    """Both packages on their C++ library, or both on the numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(tnative, "_load", lambda: None)
    elif not tnative.native_available():
        pytest.skip("no C++ toolchain for the port's native library")
    else:
        _load_jax_native(monkeypatch)
    return request.param


def _fixture(name):
    with open(os.path.join(FIXDIR, name), "rb") as f:
        return f.read(), np.load(os.path.join(FIXDIR, "oracles.npz"))[name]


def _image(seed, shape, dtype=np.uint8):
    """A smooth gradient plus noise: compressible and not trivially so."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    base = (np.add.outer(np.arange(h), np.arange(w)) * 3).astype(np.int64)
    if len(shape) == 3:
        base = base[..., None] + 40 * np.arange(shape[2])
    hi = np.iinfo(dtype).max
    return np.clip(base + rng.integers(0, 24, size=shape), 0, hi).astype(dtype)


def _payloads():
    rng = np.random.default_rng(3)
    text = b"the quick brown fox jumps over the lazy dog " * 900
    return {"zeros": bytes(70_000), "random": rng.bytes(50_000), "text": text,
            "mixed": text[:20_000] + rng.bytes(5_000) + bytes(30_000) + text[:7],
            "empty": b"", "short": b"abc"}


@pytest.mark.parametrize("name", list(_payloads()))
def test_lz4_frames_equal_the_jax_package(name, backend):
    data = _payloads()[name]
    for block in (4 << 20, 16 << 10):
        frame = tlz4.compress(data, block_size=block)
        assert frame == jlz4.compress(data, block_size=block)
        assert tlz4.decompress(frame) == data == jlz4.decompress(frame)


def test_lz4_native_blocks_equal_numpy(monkeypatch):
    if not tnative.native_available():
        pytest.skip("no C++ toolchain for the port's native library")
    _load_jax_native(monkeypatch)
    for data in _payloads().values():
        nat = tnative.lz4_block_encode_native(data)
        py = tlz4._encode_block_py(data)
        assert nat == jnative.lz4_block_encode_native(data)
        assert (nat or None) == py  # b"" (did not shrink) is the encoder's None
        if nat:
            out = np.zeros(len(data), np.uint8)
            assert tnative.lz4_block_decode_native(nat, out, 0) == len(data)
            assert out.tobytes() == data
    with pytest.raises(ValueError):
        tnative.lz4_block_decode_native(bytes([0x04]) + b"\x09\x00", np.zeros(4, np.uint8), 0)


@pytest.mark.parametrize("shape,dtype", [((40, 56, 3), np.uint8), ((33, 47), np.uint8),
                                         ((24, 30), np.uint16), ((20, 28, 4), np.uint8)])
def test_png_encode_decode_equal_the_jax_package(shape, dtype, backend):
    img = _image(sum(shape), shape, dtype)
    blob = tpng.encode_png(img)
    assert blob == jpng.encode_png(img)
    np.testing.assert_array_equal(tpng.decode_png(blob), img)
    np.testing.assert_array_equal(tpng.decode_png(blob), jpng.decode_png(blob))


@pytest.mark.parametrize("name", PNGS)
def test_png_fixtures_decode_to_the_oracle(name, backend):
    data, oracle = _fixture(name)
    np.testing.assert_array_equal(tpng.decode_png(data), oracle)
    assert tpng.probe_png(data) == jpng.probe_png(data)


@pytest.mark.parametrize("shape,quality,sub", [((40, 56, 3), 90, "444"), ((40, 56, 3), 75, "420"),
                                               ((33, 45, 3), 85, "420"), ((33, 45), 90, "444")])
def test_jpeg_encode_equals_the_jax_package(shape, quality, sub, backend):
    img = _image(7 + quality, shape)
    blob = tjpeg.encode_jpeg(img, quality=quality, subsampling=sub)
    assert blob == jjpeg.encode_jpeg(img, quality=quality, subsampling=sub)
    np.testing.assert_array_equal(tjpeg.decode_jpeg(blob), jjpeg.decode_jpeg(blob))


def test_jpeg_reference_encoders_disagree_by_one_byte(monkeypatch):
    """At (40, 56, 3), quality 75, 4:2:0 the JAX package's C++ encoder and
    its numpy fallback give different files, 956 and 957 bytes: the port's
    C++ encoder reproduces the JAX C++ one and its numpy path the JAX numpy
    one, so a mismatch in the case above under mixed libraries is the
    reference's own disagreement, not a port fault."""
    if not tnative.native_available():
        pytest.skip("no C++ toolchain for the port's native library")
    _load_jax_native(monkeypatch)
    img = _image(7 + 75, (40, 56, 3))
    enc = lambda m: m.encode_jpeg(img, quality=75, subsampling="420")  # noqa: E731
    t_native, j_native = enc(tjpeg), enc(jjpeg)
    with monkeypatch.context() as m:
        m.setattr(jnative, "_load", lambda: None)
        m.setattr(tnative, "_load", lambda: None)
        t_numpy, j_numpy = enc(tjpeg), enc(jjpeg)
    assert t_native == j_native
    assert t_numpy == j_numpy
    assert (len(j_native), len(j_numpy)) == (956, 957)
    assert j_native != j_numpy[: len(j_native)]


@pytest.mark.parametrize("name", JPEGS)
def test_jpeg_fixtures_decode_to_the_oracle(name, backend):
    data, oracle = _fixture(name)
    img = tjpeg.decode_jpeg(data)
    np.testing.assert_array_equal(img, oracle)
    np.testing.assert_array_equal(img, jjpeg.decode_jpeg(data))
    assert tjpeg.probe_jpeg(data) == jjpeg.probe_jpeg(data)


def test_jpeg_native_entry_points_equal_the_numpy_paths(monkeypatch):
    if not tnative.native_available():
        pytest.skip("no C++ toolchain for the port's native library")
    for name in JPEGS:
        data, oracle = _fixture(name)
        np.testing.assert_array_equal(tnative.jpeg_decode_native(data), oracle)
    with pytest.raises(tjpeg.JpegError):
        tnative.jpeg_decode_native(_fixture("rgb_q90_444.jpg")[0][:40])
    img = _image(11, (32, 40, 3))
    native = {s: tnative.jpeg_encode_native(img, 90, subsampling=s) for s in ("444", "420")}
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert tnative.jpeg_encode_native(img, 90) is None
    for s, blob in native.items():
        assert blob == tjpeg.encode_jpeg(img, quality=90, subsampling=s)
    data = tpng.encode_png(img)
    assert tnative.png_unfilter_native(data, 1, 1, 1) is None


def test_gif_encode_decode_equal_the_jax_package():
    frames = [_image(s, (24, 32, 3)) for s in range(3)]
    blob = tgif.encode_gif(frames, delay_cs=7)
    assert blob == jgif.encode_gif(frames, delay_cs=7)
    np.testing.assert_array_equal(tgif.median_cut_palette(frames, 16),
                                  jgif.median_cut_palette(frames, 16))
    (tf, td), (jf, jd) = tgif.decode_gif(blob), jgif.decode_gif(blob)
    assert td == jd == [7, 7, 7]
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a, b)
    pal = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    idx = [np.random.default_rng(s).integers(0, 4, (9, 13)).astype(np.uint8) for s in range(2)]
    blob = tgif.encode_gif(idx, palette=pal, loop=None)
    assert blob == jgif.encode_gif(idx, palette=pal, loop=None)
    np.testing.assert_array_equal(tgif.decode_gif(blob)[0][1], pal[idx[1]])


def test_cloud_wire_codec_equals_the_jax_package():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(257, 4)).astype(np.float32)
    pts[3, 1] = np.nan
    th, jh = THeader(stamp=2.5, frame_id="map", seq=4), JHeader(stamp=2.5, frame_id="map", seq=4)
    for enc in ("encode_xyz", "encode_xyzirgb"):
        arg = pts if enc == "encode_xyz" else np.concatenate(
            [pts, rng.integers(0, 255, size=(257, 3)).astype(np.float32)], axis=1)
        tw, jw = getattr(tcodec, enc)(arg, th), getattr(jcodec, enc)(arg, jh)
        assert tw.data == jw.data
        assert [(f.name, f.offset, f.datatype, f.count) for f in tw.fields] == \
               [(f.name, f.offset, f.datatype, f.count) for f in jw.fields]
        assert (tw.height, tw.width, tw.point_step, tw.is_dense) == \
               (jw.height, jw.width, jw.point_step, jw.is_dense)
        for ext in ("extract_xyz", "extract_xyzrgb", "extract_xyzirgb"):
            if enc == "encode_xyz" and ext != "extract_xyz":
                continue
            for nans in (True, False):
                np.testing.assert_array_equal(getattr(tcodec, ext)(tw, nans),
                                              getattr(jcodec, ext)(jw, nans))
    tmsg = tcodec.wire_to_cloud_msg(tcodec.encode_xyz(pts, th))
    jmsg = jcodec.wire_to_cloud_msg(jcodec.encode_xyz(pts, jh))
    np.testing.assert_array_equal(tmsg.points, jmsg.points)
    assert tcodec.cloud_msg_to_wire(tmsg).data == jcodec.cloud_msg_to_wire(jmsg).data
    finite = np.isfinite(pts).all(axis=1)
    np.testing.assert_array_equal(tmsg.points, pts[finite])  # the NaN row is dropped
