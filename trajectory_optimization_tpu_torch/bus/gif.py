"""From-spec GIF89a codec (encode + decode), pure numpy/stdlib.

Copy of ``trajectory_optimization_tpu/bus/gif.py``.

The reference documents every demo mode with an animated GIF
(`reference/README.md:27,52,64,71,80` — hpr.gif, cam_pose_opt.gif,
cam_wps_opt.gif, cam_traj_eval.gif, cam_traj_opt.gif, recorded from rviz).
This framework renders headless (`ops/render.py`, `demos/visualize.py`);
this module supplies the missing last step — packaging rendered frame
sequences into the same artifact format — with the package's from-spec
codec discipline (same pattern as bus/jpeg.py and bus/png.py: no PIL/cv2
at runtime; tests use PIL as the oracle).

Implements the GIF89a specification (CompuServe, 1990): logical screen +
global color table, per-frame graphic-control extensions (delay,
disposal), the NETSCAPE2.0 looping application extension, and GIF-variant
LZW (variable code width 3..12 bits, CLEAR/EOI codes, LSB-first bit
packing in ≤255-byte sub-blocks). Quantization is median-cut to ≤256
colors with a 32³ RGB lookup cube for fast nearest-palette mapping.

`demos/make_gifs.py` uses this to regenerate the reference README's demo
GIFs from the real sample data on the actual optimizers.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "GifError",
    "median_cut_palette",
    "quantize_to_palette",
    "encode_gif",
    "decode_gif",
]

_MAX_CODE = 1 << 12  # GIF LZW codes are at most 12 bits wide


class GifError(ValueError):
    """Malformed or unsupported GIF stream."""


# ---------------------------------------------------------------------------
# palette


def median_cut_palette(frames: Sequence[np.ndarray], n_colors: int = 256,
                       sample: int = 1 << 16) -> np.ndarray:
    """Median-cut palette over all frames' pixels.

    Classic Heckbert median cut: start with one box holding (a sample of)
    all pixels; repeatedly split the box with the widest channel range at
    that channel's median until ``n_colors`` boxes; palette = per-box mean.
    Returns (P, 3) uint8 with P ≤ n_colors.
    """
    px = np.concatenate([np.asarray(f, np.uint8).reshape(-1, 3) for f in frames])
    if len(px) > sample:
        # deterministic stride sample (demo artifacts must be reproducible);
        # ceil-divide so the stride spans the WHOLE pixel range — floor
        # division truncated to the first `sample` pixels (top of frame 0)
        # and starved trailing frames' colors out of the palette
        px = px[:: -(-len(px) // sample)]
    px = px.astype(np.int32)
    boxes: List[np.ndarray] = [px]
    while len(boxes) < n_colors:
        # split the box with the widest channel range; stop when no box
        # has two distinct colors left
        spans = [b.max(axis=0) - b.min(axis=0) if len(b) > 1 else np.zeros(3, np.int32)
                 for b in boxes]
        widest = int(np.argmax([s.max() for s in spans]))
        if spans[widest].max() == 0:
            break
        ch = int(np.argmax(spans[widest]))
        b = boxes.pop(widest)
        order = np.argsort(b[:, ch], kind="stable")
        half = len(order) // 2
        boxes.append(b[order[:half]])
        boxes.append(b[order[half:]])
    pal = np.array([b.mean(axis=0) for b in boxes if len(b)], np.float64)
    return np.clip(np.round(pal), 0, 255).astype(np.uint8)


def quantize_to_palette(frame: np.ndarray, palette: np.ndarray,
                        _cube_cache: dict = {}) -> np.ndarray:
    """Map an (H, W, 3) uint8 frame to nearest-palette indices (H, W) uint8.

    Exact per-pixel nearest search is O(pixels × P); instead a 32³ RGB
    lookup cube is built once per palette (32768 × P distance table) and
    pixels index it by their top-5 bits per channel — ≤4/channel extra
    error on top of the palette's own quantization, invisible in a GIF.
    """
    key = palette.tobytes()
    cube = _cube_cache.get(key)
    if cube is None:
        grid = np.arange(32, dtype=np.int32) * 8 + 4  # cell centers
        r, g, b = np.meshgrid(grid, grid, grid, indexing="ij")
        cells = np.stack([r, g, b], axis=-1).reshape(-1, 1, 3)  # (32768,1,3)
        pal = palette.astype(np.int32)[None]  # (1,P,3)
        d = ((cells - pal) ** 2).sum(axis=-1)  # (32768, P)
        cube = d.argmin(axis=1).astype(np.uint8).reshape(32, 32, 32)
        if len(_cube_cache) > 8:  # demos build a handful of palettes
            _cube_cache.clear()
        _cube_cache[key] = cube
    f = np.asarray(frame, np.uint8)
    return cube[f[..., 0] >> 3, f[..., 1] >> 3, f[..., 2] >> 3]


# ---------------------------------------------------------------------------
# LZW (GIF variant)


def _lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF-variant LZW: emits CLEAR, then codes growing from
    min_code_size+1 up to 12 bits, re-emitting CLEAR when the table fills
    (4096 codes), and EOI last. LSB-first bit packing."""
    clear = 1 << min_code_size
    eoi = clear + 1

    out = bytearray()
    acc = 0
    nbits = 0

    def emit(code: int, width: int):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table = {(-1, k): k for k in range(clear)}
    next_code = eoi + 1
    width = min_code_size + 1
    emit(clear, width)

    data = indices.reshape(-1).astype(np.int32).tolist()
    if not data:
        raise GifError("empty frame")
    w = data[0]
    for k in data[1:]:
        wk = (w, k)
        code = table.get(wk)
        if code is not None:
            w = code
            continue
        emit(w, width)
        table[wk] = next_code
        next_code += 1
        # the DECODER adds its mirror entry one code behind, so the width
        # bump happens when next_code EXCEEDS the current range
        if next_code > (1 << width) and width < 12:
            width += 1
        if next_code >= _MAX_CODE:
            emit(clear, width)
            table = {(-1, k): k for k in range(clear)}
            next_code = eoi + 1
            width = min_code_size + 1
        w = k
    emit(w, width)
    emit(eoi, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _lzw_decode(data: bytes, min_code_size: int, n_expected: int) -> np.ndarray:
    """Inverse of :func:`_lzw_encode`; stops at EOI or when ``n_expected``
    pixels are recovered (some writers omit EOI)."""
    if not 2 <= min_code_size <= 11:
        raise GifError(f"bad LZW min code size {min_code_size}")
    clear = 1 << min_code_size
    eoi = clear + 1

    pos = 0
    acc = 0
    nbits = 0

    def read(width: int) -> int:
        nonlocal pos, acc, nbits
        while nbits < width:
            if pos >= len(data):
                return eoi  # truncated stream: treat as end
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        return code

    out = np.empty(n_expected, np.uint8)
    n_out = 0

    def reset():
        return [bytes([k]) for k in range(clear)] + [b"", b""], min_code_size + 1

    table, width = reset()
    prev: Optional[bytes] = None
    while n_out < n_expected:
        code = read(width)
        if code == eoi:
            break
        if code == clear:
            table, width = reset()
            prev = None
            continue
        if code < len(table):
            entry = table[code]
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]  # the KwKwK case
        else:
            raise GifError(f"LZW code {code} out of range")
        take = min(len(entry), n_expected - n_out)
        out[n_out : n_out + take] = np.frombuffer(entry[:take], np.uint8)
        n_out += take
        if prev is not None and len(table) < _MAX_CODE:
            table.append(prev + entry[:1])
            if len(table) == (1 << width) and width < 12:
                width += 1
        prev = entry
    if n_out != n_expected:
        raise GifError(f"LZW stream ended at {n_out}/{n_expected} pixels")
    return out


def _sub_blocks(payload: bytes) -> bytes:
    """Wrap payload into ≤255-byte length-prefixed sub-blocks + terminator."""
    out = bytearray()
    for i in range(0, len(payload), 255):
        chunk = payload[i : i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


# ---------------------------------------------------------------------------
# container


def encode_gif(
    frames: Sequence[np.ndarray],
    *,
    delay_cs: int = 10,
    loop: int = 0,
    palette: Optional[np.ndarray] = None,
    n_colors: int = 256,
) -> bytes:
    """Encode (H, W, 3) uint8 frames (or (H, W) palette indices) as an
    animated GIF89a.

    Args:
      frames: equal-shape frames. RGB frames are median-cut quantized with
        ONE global palette (GIF color fidelity is per-palette; a shared
        palette keeps the animation flicker-free). (H, W) uint8 frames are
        used as palette indices directly (``palette`` required).
      delay_cs: per-frame delay in centiseconds (GIF's native unit).
      loop: 0 = loop forever (the reference README GIFs loop); None = play
        once (omit the NETSCAPE extension).
      palette: optional (P ≤ 256, 3) uint8 palette override.
    """
    if not frames:
        raise GifError("no frames")
    first = np.asarray(frames[0])
    if first.ndim == 2:
        if palette is None:
            raise GifError("index frames require an explicit palette")
        idx_frames = [np.asarray(f, np.uint8) for f in frames]
    else:
        # reject RGBA/odd channel counts up front: median_cut_palette's
        # reshape(-1, 3) would silently misalign 4-channel pixel triples
        # into a scrambled (but valid-looking) palette
        for f in frames:
            f = np.asarray(f)
            if f.ndim != 3 or f.shape[-1] != 3:
                raise GifError(
                    f"RGB frames must be (H, W, 3) uint8, got {f.shape}")
        if palette is None:
            palette = median_cut_palette(frames, n_colors)
        idx_frames = [quantize_to_palette(f, palette) for f in frames]
    h, w = idx_frames[0].shape
    for f in idx_frames:
        if f.shape != (h, w):
            raise GifError("all frames must share one shape")

    pal = np.asarray(palette, np.uint8)
    if pal.ndim != 2 or pal.shape[1] != 3 or len(pal) > 256:
        raise GifError(f"palette must be (P<=256, 3) uint8, got {pal.shape}")
    # explicit index frames must reference real palette entries — an index
    # >= len(pal) emits an undecodable color reference, and one reaching the
    # LZW CLEAR/EOI codes silently corrupts the stream
    for f in idx_frames:
        top = int(f.max(initial=0))
        if top >= len(pal):
            raise GifError(f"frame index {top} out of range for {len(pal)}-entry palette")
    # global color table size is a power of two >= 2
    gct_bits = max(1, int(len(pal) - 1).bit_length())
    gct = np.zeros((1 << gct_bits, 3), np.uint8)
    gct[: len(pal)] = pal
    min_code_size = max(2, gct_bits)

    out = bytearray(b"GIF89a")
    out += struct.pack("<HH", w, h)
    out.append(0x80 | (7 << 4) | (gct_bits - 1))  # GCT present, 8-bit res
    out.append(0)  # background color index
    out.append(0)  # pixel aspect ratio
    out += gct.tobytes()

    if loop is not None and len(idx_frames) > 1:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
        out += struct.pack("<H", int(loop) & 0xFFFF)
        out.append(0)

    for f in idx_frames:
        out += b"\x21\xf9\x04"  # graphic control extension
        out.append(0)  # disposal = unspecified, no transparency
        out += struct.pack("<H", max(0, int(delay_cs)) & 0xFFFF)
        out += b"\x00\x00"  # transparent index (unused), terminator
        out += b"\x2c" + struct.pack("<HHHH", 0, 0, w, h) + b"\x00"
        out.append(min_code_size)
        out += _sub_blocks(_lzw_encode(f, min_code_size))
    out.append(0x3B)  # trailer
    return bytes(out)


def _read_sub_blocks(buf: bytes, pos: int) -> Tuple[bytes, int]:
    out = bytearray()
    while True:
        if pos >= len(buf):
            raise GifError("truncated sub-blocks")
        n = buf[pos]
        pos += 1
        if n == 0:
            return bytes(out), pos
        if pos + n > len(buf):
            raise GifError("truncated sub-block payload")
        out += buf[pos : pos + n]
        pos += n


def decode_gif(buf: bytes) -> Tuple[List[np.ndarray], List[int]]:
    """Decode a GIF into (frames, per-frame delays in centiseconds).

    Frames come back as (H, W, 3) uint8 RGB composited onto the logical
    screen. Supports global/local color tables, interlace, disposal
    methods 0-2 and transparency — the subset every real-world GIF writer
    (including :func:`encode_gif`, PIL, rviz screen recorders) emits.
    """
    if len(buf) < 13 or buf[:4] != b"GIF8" or buf[4:6] not in (b"7a", b"9a"):
        raise GifError("not a GIF87a/89a stream")
    W, H = struct.unpack_from("<HH", buf, 6)
    if W * H > 1 << 26:  # ~200 MB RGB screen: far beyond any real GIF —
        # a corrupt header must not become a 12 GB allocation bomb
        raise GifError(f"implausible {W}x{H} logical screen")
    packed = buf[10]
    pos = 13
    gct = None
    if packed & 0x80:
        size = 2 << (packed & 7)
        if pos + size * 3 > len(buf):
            raise GifError("truncated global color table")
        gct = np.frombuffer(buf[pos : pos + size * 3], np.uint8).reshape(-1, 3)
        pos += size * 3

    bg = np.zeros((H, W, 3), np.uint8)
    if gct is not None:
        bg[:] = gct[min(buf[11], len(gct) - 1)]
    screen = bg.copy()
    frames: List[np.ndarray] = []
    delays: List[int] = []
    transparent = -1
    delay = 0
    disposal = 0

    while pos < len(buf):
        b0 = buf[pos]
        pos += 1
        if b0 == 0x3B:  # trailer
            break
        if b0 == 0x21:  # extension
            if pos >= len(buf):
                raise GifError("truncated extension block")
            label = buf[pos]
            pos += 1
            data, pos = _read_sub_blocks(buf, pos)
            if label == 0xF9 and len(data) >= 4:
                disposal = (data[0] >> 2) & 7
                delay = struct.unpack_from("<H", data, 1)[0]
                transparent = data[3] if data[0] & 1 else -1
            continue
        if b0 != 0x2C:
            raise GifError(f"unexpected block 0x{b0:02x}")
        if pos + 9 > len(buf):
            raise GifError("truncated image descriptor")
        left, top, w, h = struct.unpack_from("<HHHH", buf, pos)
        pos += 8
        if left + w > W or top + h > H:
            raise GifError(f"image rect {w}x{h}+{left}+{top} exceeds {W}x{H} screen")
        ipacked = buf[pos]
        pos += 1
        table = gct
        if ipacked & 0x80:
            size = 2 << (ipacked & 7)
            if pos + size * 3 > len(buf):
                raise GifError("truncated local color table")
            table = np.frombuffer(buf[pos : pos + size * 3], np.uint8).reshape(-1, 3)
            pos += size * 3
        if table is None:
            raise GifError("image without any color table")
        if pos >= len(buf):
            raise GifError("truncated image data")
        mcs = buf[pos]
        pos += 1
        data, pos = _read_sub_blocks(buf, pos)
        idx = _lzw_decode(data, mcs, w * h).reshape(h, w)
        if ipacked & 0x40:  # interlaced: 4-pass row shuffle
            rows = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                   np.arange(2, h, 4), np.arange(1, h, 2)])
            un = np.empty_like(idx)
            un[rows] = idx
            idx = un
        if idx.max(initial=0) >= len(table):
            raise GifError("palette index out of range")
        prev = screen.copy() if disposal == 3 else None
        region = screen[top : top + h, left : left + w]
        rgb = table[idx]
        if transparent >= 0:
            keep = idx == transparent
            rgb = np.where(keep[..., None], region, rgb)
        screen[top : top + h, left : left + w] = rgb
        frames.append(screen.copy())
        delays.append(delay)
        if disposal == 2:
            screen[top : top + h, left : left + w] = bg[top : top + h, left : left + w]
        elif disposal == 3 and prev is not None:
            screen = prev
        # a graphic-control extension applies to exactly ONE following image
        # (GIF89a §23) — delay included; frames without their own GCE get 0
        transparent = -1
        disposal = 0
        delay = 0
    if not frames:
        raise GifError("no image frames")
    return frames, delays
