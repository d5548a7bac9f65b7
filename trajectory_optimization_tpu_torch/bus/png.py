"""From-spec PNG (RFC 2083) decoder — stdlib zlib + NumPy.

Copy of ``trajectory_optimization_tpu/bus/png.py``, on the port's
``native/`` entry points.

Companion to :mod:`bus.jpeg` for ``sensor_msgs/CompressedImage`` payloads:
ROS's compressed transport writes PNG for lossless streams (notably 16-bit
depth images). Inflate comes from the Python stdlib; everything else
(chunk walk, scanline unfiltering, sample unpacking) is implemented here
from the spec.

Scope: 8/16-bit greyscale, truecolor, palette, and alpha variants,
non-interlaced or Adam7-interlaced (each interlace pass is an
independently filtered sub-image scattered onto the pixel grid).
Returns uint8 or uint16 arrays, (H, W) / (H, W, C).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png", "probe_png",
           "PngError", "UnsupportedPngError"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngError(ValueError):
    """Malformed PNG stream."""


class UnsupportedPngError(PngError):
    """Valid PNG, but outside the supported subset (exotic bit depth)."""


# Adam7 pass grid: (x_start, y_start, x_step, y_step) per pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(buf: bytes):
    if buf[:8] != _SIGNATURE:
        raise PngError("missing PNG signature")
    i = 8
    n = len(buf)
    while i + 8 <= n:
        (length,) = struct.unpack(">I", buf[i:i + 4])
        ctype = buf[i + 4:i + 8]
        data = buf[i + 8:i + 8 + length]
        if len(data) != length:
            raise PngError("truncated chunk")
        yield ctype, data
        i += 12 + length  # skip CRC (integrity left to the transport)
        if ctype == b"IEND":
            return
    raise PngError("missing IEND")


def _guard(fn, *args):
    """Surface every malformed-stream failure as PngError (short IHDR and
    friends otherwise leak struct.error past callers catching PngError)."""
    try:
        return fn(*args)
    except PngError:
        raise
    except (IndexError, ValueError, struct.error) as e:
        raise PngError(f"malformed stream: {e}") from e


def probe_png(buf: bytes):
    """Return (height, width, channels, bit_depth) from IHDR."""
    return _guard(_probe_png, bytes(buf))


def _probe_png(buf: bytes):
    for ctype, data in _chunks(buf):
        if ctype == b"IHDR":
            w, h, depth, color, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", data)
            if color not in _CHANNELS:
                raise PngError(f"bad colour type {color}")
            return h, w, _CHANNELS[color], depth
        raise PngError("first chunk is not IHDR")
    raise PngError("empty stream")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo per-scanline filtering -> (height, stride) uint8.

    C++ fast path when built (native.png_unfilter — the Sub/Average/Paeth
    recurrences are serial per byte, ~seconds per 2MP frame in Python);
    identical pure-Python fallback below."""
    if len(raw) != height * (stride + 1):
        raise PngError("decompressed size mismatch")
    from trajectory_optimization_tpu_torch.native import png_unfilter_native

    try:
        native = png_unfilter_native(raw, height, stride, bpp)
    except ValueError as e:
        raise PngError(str(e)) from e
    if native is not None:
        return native
    data = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    filters = data[:, 0]
    rows = data[:, 1:].astype(np.int32)
    out = np.zeros((height, stride), dtype=np.int32)
    prev = np.zeros(stride, dtype=np.int32)
    for r in range(height):
        f = filters[r]
        row = rows[r]
        if f == 0:  # None
            cur = row
        elif f == 1:  # Sub: serial in x with lag bpp -> cumsum per lane
            cur = row.copy()
            for lane in range(bpp):
                np.cumsum(cur[lane::bpp], out=cur[lane::bpp])
            cur &= 0xFF
        elif f == 2:  # Up
            cur = (row + prev) & 0xFF
        elif f == 3:  # Average (serial)
            cur = row.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif f == 4:  # Paeth (serial)
            cur = row.copy()
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                cur[x] = (cur[x] + _paeth(a, b, c)) & 0xFF
        else:
            raise PngError(f"bad filter type {f}")
        out[r] = cur
        prev = cur
    return out.astype(np.uint8)


def decode_png(buf: bytes) -> np.ndarray:
    return _guard(_decode_png, bytes(buf))


def _decode_png(buf: bytes) -> np.ndarray:
    ihdr = None
    palette = None
    idat = []
    for ctype, data in _chunks(buf):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(data)
    if ihdr is None:
        raise PngError("missing IHDR")
    width, height, depth, color, comp, filt, interlace = ihdr
    if comp != 0 or filt != 0:
        raise PngError("unknown compression/filter method")
    if interlace not in (0, 1):
        raise PngError(f"bad interlace method {interlace}")
    if color not in _CHANNELS:
        raise PngError(f"bad colour type {color}")
    if depth not in (8, 16) or (color == 3 and depth != 8):
        raise UnsupportedPngError(f"bit depth {depth} for colour type {color}")
    if width == 0 or height == 0:
        raise PngError("zero-sized image")
    channels = _CHANNELS[color]
    bytes_per_sample = depth // 8
    bpp = channels * bytes_per_sample
    stride = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"bad IDAT stream: {e}") from e
    if interlace == 1:
        # Adam7: each pass is a separately filtered sub-image (empty
        # passes contribute no bytes, not even filter bytes); unfilter
        # each and scatter onto the pixel grid
        flat = np.zeros((height, width, bpp), dtype=np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = (width - x0 + dx - 1) // dx
            ph = (height - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            pstride = pw * bpp
            size = ph * (pstride + 1)
            sub = _unfilter(raw[off:off + size], ph, pstride, bpp)
            off += size
            flat[y0::dy, x0::dx] = sub.reshape(ph, pw, bpp)
        if off != len(raw):
            raise PngError("decompressed size mismatch")
        flat = flat.reshape(height, stride)
    else:
        flat = _unfilter(raw, height, stride, bpp)
    if depth == 16:
        img = flat.reshape(height, width, channels, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]  # network byte order
    else:
        img = flat.reshape(height, width, channels)
    if color == 3:
        if palette is None:
            raise PngError("palette image without PLTE")
        idx = img[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise PngError("palette index out of range")
        return palette[idx]
    if channels == 1:
        return img[..., 0]
    return img


def _crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _chunk(ctype: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", _crc32(ctype + data)))


def encode_png(img: np.ndarray, *, level: int = 6) -> bytes:
    """Encode uint8/uint16 gray, RGB, or RGBA as non-interlaced PNG.

    Spec-minimal writer (filter type 0 on every scanline, one IDAT); the
    lossless counterpart to :func:`bus.jpeg.encode_jpeg` for bag copies of
    16-bit depth streams.
    """
    img = np.asarray(img)
    if img.ndim == 2:
        channels, color = 1, 0
    elif img.ndim == 3 and img.shape[2] in (1, 2, 3, 4):
        channels = img.shape[2]
        if channels == 1:
            img = img[..., 0]
            color = 0
        else:
            color = {2: 4, 3: 2, 4: 6}[channels]  # 4 = grey+alpha
    else:
        raise ValueError(f"cannot encode shape {img.shape} as PNG")
    if img.dtype == np.uint8:
        depth = 8
        raw = img
    elif img.dtype == np.uint16:
        if color == 6:
            raise ValueError("16-bit RGBA not supported")
        depth = 16
        raw = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot encode dtype {img.dtype} as PNG")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("empty image")
    rows = np.ascontiguousarray(raw).reshape(h, -1)
    filtered = np.zeros((h, rows.shape[1] + 1), dtype=np.uint8)
    filtered[:, 1:] = rows
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    idat = zlib.compress(filtered.tobytes(), level)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))
