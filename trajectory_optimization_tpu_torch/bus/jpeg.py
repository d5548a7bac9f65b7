"""From-spec baseline JPEG (ITU-T T.81) decoder — pure NumPy.

Copy of ``trajectory_optimization_tpu/bus/jpeg.py``, on the port's
``native/`` entry points.

The reference's real session bag carries all six camera streams as
``sensor_msgs/CompressedImage`` JPEG payloads (reference
``launch/rosbag_info.txt:15,30-41``) and displays them via cv_bridge/cv2
(reference ``src/tools.py:199-204``, ``src/pc_processor.py:190-197``).  This
module is the framework's own codec for those payloads: no cv2/PIL at
runtime — a C++ fast path lives in ``native/trajopt_native.cpp``
(``jpeg_decode``), and this file is the bit-exact-specified fallback plus
the single source of truth for the numerics both paths implement.

Scope: baseline/extended sequential (SOF0/SOF1, interleaved or multi-scan
non-interleaved) AND progressive DCT (SOF2 — spectral selection +
successive approximation, T.81 Annexes G.2/F.2.2, the jdphuff.c
algorithms), 8-bit, grayscale or YCbCr, arbitrary h/v sampling factors
(4:4:4 / 4:2:2 / 4:2:0 / 4:1:1), restart markers, 8/16-bit quantization
tables.  Lossless / hierarchical / arithmetic coding raise
``UnsupportedJpegError`` — callers keep the compressed passthrough then.

Numerics ARE libjpeg's integer pipeline — the decode matches PIL/cv2
BIT-FOR-BIT (pinned in tests across quality/subsampling/odd dims):
fixed-point islow IDCT (jidctint.c constants, CONST_BITS=13), triangular
"fancy" chroma upsampling for factor-2 dims, 16.16 fixed-point YCbCr→RGB.
Integer end to end, so the C++ fast path is bit-identical to this module
with no FMA/summation-order caveats.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["decode_jpeg", "encode_jpeg", "probe_jpeg",
           "UnsupportedJpegError", "JpegError"]


class JpegError(ValueError):
    """Malformed JPEG stream."""


class UnsupportedJpegError(JpegError):
    """Valid JPEG, but outside the supported DCT subset (lossless,
    hierarchical, arithmetic-coded, or >8-bit precision)."""


# zig-zag scan order: _ZIGZAG[k] = raster index of the k-th coefficient
_ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# 8-point DCT basis: A[x, u] = c(u)/2 * cos((2x+1) u pi / 16) (encoder FDCT)
_A = np.array([
    [(np.sqrt(0.5) if u == 0 else 1.0) / 2.0 * np.cos((2 * x + 1) * u * np.pi / 16.0)
     for u in range(8)] for x in range(8)
], dtype=np.float64)


def _islow_1d(i0, i1, i2, i3, i4, i5, i6, i7, shift):
    """One libjpeg ``jpeg_idct_islow`` butterfly pass on int64 arrays.

    Fixed-point Loeffler-Ligtenberg-Moshovitz 8-point IDCT, CONST_BITS=13
    (constants = round(x·8192), jidctint.c). Inputs are the 8 frequency
    samples (vectorized: each an array of the parallel lanes), outputs the
    8 spatial samples, each DESCALEd by ``shift`` with round-half-up
    (arithmetic right shift — numpy ``>>`` on int64 floors, like C on
    every platform libjpeg supports). Integer math end to end, so the C++
    path reproduces it bit-for-bit with no FMA-contraction caveats.
    """
    half = 1 << (shift - 1)
    # even part
    z1 = (i2 + i6) * 4433            # FIX_0_541196100
    tmp2 = z1 - i6 * 15137           # + i6 * -FIX_1_847759065
    tmp3 = z1 + i2 * 6270            # + i2 * FIX_0_765366865
    tmp0 = (i0 + i4) << 13
    tmp1 = (i0 - i4) << 13
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    # odd part
    z1 = i7 + i1
    z2 = i5 + i3
    z3 = i7 + i3
    z4 = i5 + i1
    z5 = (z3 + z4) * 9633            # FIX_1_175875602
    t0 = i7 * 2446                   # FIX_0_298631336
    t1 = i5 * 16819                  # FIX_2_053119869
    t2 = i3 * 25172                  # FIX_3_072711026
    t3 = i1 * 12299                  # FIX_1_501321110
    z1 = z1 * -7373                  # -FIX_0_899976223
    z2 = z2 * -20995                 # -FIX_2_562915447
    z3 = z3 * -16069 + z5            # -FIX_1_961570560
    z4 = z4 * -3196 + z5             # -FIX_0_390180644
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return ((t10 + t3 + half) >> shift, (t11 + t2 + half) >> shift,
            (t12 + t1 + half) >> shift, (t13 + t0 + half) >> shift,
            (t13 - t0 + half) >> shift, (t12 - t1 + half) >> shift,
            (t11 - t2 + half) >> shift, (t10 - t3 + half) >> shift)


def _idct_islow(deq: np.ndarray) -> np.ndarray:
    """(n, 8, 8) int64 dequantized natural-order blocks → (n, 8, 8) int64
    spatial samples (before +128 level shift / clipping).

    Two ``_islow_1d`` passes exactly like libjpeg: columns (DESCALE by
    CONST_BITS−PASS1_BITS = 11), then rows (DESCALE by
    CONST_BITS+PASS1_BITS+3 = 18). Worst-case error vs the exact real
    IDCT is ≤1 count — the same bound libjpeg itself carries.
    """
    cols = _islow_1d(*(deq[:, r, :] for r in range(8)), shift=11)
    ws = np.stack(cols, axis=1)            # (n, row, col), half-transformed
    rows = _islow_1d(*(ws[:, :, c] for c in range(8)), shift=18)
    return np.stack(rows, axis=2)

# libjpeg jdcolor.c 16.16 fixed-point YCbCr->RGB constants
_FIX_1_40200 = 91881
_FIX_1_77200 = 116130
_FIX_0_34414 = 22554
_FIX_0_71414 = 46802


class _Huff:
    """Canonical Huffman table as a flat 16-bit-peek LUT."""

    __slots__ = ("lut_len", "lut_val")

    def __init__(self, counts: np.ndarray, values: np.ndarray):
        self.lut_len = np.zeros(1 << 16, dtype=np.uint8)
        self.lut_val = np.zeros(1 << 16, dtype=np.uint8)
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(int(counts[length - 1])):
                if code >= (1 << length):
                    raise JpegError("overfull Huffman table")
                lo = code << (16 - length)
                hi = lo + (1 << (16 - length))
                self.lut_len[lo:hi] = length
                self.lut_val[lo:hi] = values[k]
                code += 1
                k += 1
            code <<= 1


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "td", "ta", "coef", "nbx", "nby")

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.td = self.ta = 0
        self.coef: Optional[np.ndarray] = None  # (nblocks, 64) zigzag order
        self.nbx = self.nby = 0


def _u16(buf: bytes, i: int) -> int:
    return (buf[i] << 8) | buf[i + 1]


def probe_jpeg(buf: bytes) -> Tuple[int, int, int]:
    """Return (height, width, n_components) from the SOF header.

    Raises JpegError / UnsupportedJpegError like :func:`decode_jpeg`.
    """
    return _parse_guarded(memoryview(bytes(buf)), headers_only=True)


def decode_jpeg(buf: bytes) -> np.ndarray:
    """Decode a baseline or progressive JPEG to uint8 (H, W) grayscale or
    (H, W, 3) RGB."""
    return _parse_guarded(memoryview(bytes(buf)), headers_only=False)


def _parse_guarded(buf, headers_only: bool):
    """Every malformed-stream failure mode surfaces as JpegError — truncated
    segments otherwise leak IndexError/struct.error past the callers'
    error contract (decode_compressed_payload catches JpegError only)."""
    try:
        return _parse(buf, headers_only=headers_only)
    except JpegError:
        raise
    except (IndexError, ValueError, struct.error) as e:
        raise JpegError(f"malformed stream: {e}") from e


def _parse(buf, headers_only: bool):
    n = len(buf)
    if n < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        raise JpegError("missing SOI marker")
    i = 2
    qt: Dict[int, np.ndarray] = {}
    huff_dc: Dict[int, _Huff] = {}
    huff_ac: Dict[int, _Huff] = {}
    comps: List[_Component] = []
    height = width = 0
    restart_interval = 0
    sof_seen = False
    progressive = False
    geom = None          # (hmax, vmax, mcus_x, mcus_y) once coef allocated
    decoded_any = False

    while i < n:
        if buf[i] != 0xFF:
            raise JpegError(f"expected marker at byte {i}")
        while i < n and buf[i] == 0xFF:
            i += 1  # fill bytes before a marker are legal
        if i >= n:
            raise JpegError("truncated stream")
        marker = buf[i]
        i += 1
        if marker == 0xD9:  # EOI
            if decoded_any:
                break  # all scans in — reconstruct below
            raise JpegError("EOI before SOS")
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue  # standalone markers
        if i + 2 > n:
            raise JpegError("truncated marker segment")
        seglen = _u16(buf, i)
        if seglen < 2 or i + seglen > n:
            raise JpegError("bad segment length")
        seg = bytes(buf[i + 2:i + seglen])
        i += seglen

        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq == 0:
                    tbl = np.frombuffer(seg[p:p + 64], np.uint8).astype(np.int32)
                    p += 64
                elif pq == 1:
                    tbl = np.frombuffer(seg[p:p + 128], ">u2").astype(np.int32)
                    p += 128
                else:
                    raise JpegError("bad DQT precision")
                if tbl.size != 64:
                    raise JpegError("truncated DQT")
                qt[tq] = tbl  # zigzag order
        elif marker == 0xC4:  # DHT
            p = 0
            while p + 17 <= len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = np.frombuffer(seg[p + 1:p + 17], np.uint8)
                total = int(counts.sum())
                values = np.frombuffer(seg[p + 17:p + 17 + total], np.uint8)
                if values.size != total:
                    raise JpegError("truncated DHT")
                p += 17 + total
                (huff_dc if tc == 0 else huff_ac)[th] = _Huff(counts, values)
        elif marker in (0xC0, 0xC1, 0xC2):  # sequential / progressive DCT
            if sof_seen:
                raise JpegError("multiple SOF markers")
            sof_seen = True
            progressive = marker == 0xC2
            if seg[0] != 8:
                raise UnsupportedJpegError(f"{seg[0]}-bit precision")
            height, width = _u16(seg, 1), _u16(seg, 3)
            nf = seg[5]
            if height == 0 or width == 0:
                raise UnsupportedJpegError("DNL-deferred dimensions")
            if nf not in (1, 3):
                raise UnsupportedJpegError(f"{nf}-component image")
            for c in range(nf):
                cid, hv, tq = seg[6 + 3 * c], seg[7 + 3 * c], seg[8 + 3 * c]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4):
                    raise JpegError("bad sampling factors")
                comps.append(_Component(cid, h, v, tq))
            if headers_only:
                return height, width, nf
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7,
                        0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise UnsupportedJpegError(
                f"SOF{marker - 0xC0} (non-DCT / arithmetic) not supported")
        elif marker == 0xDD:  # DRI
            restart_interval = _u16(seg, 0)
        elif marker == 0xDA:  # SOS
            if not sof_seen:
                raise JpegError("SOS before SOF")
            ns = seg[0]
            if not 1 <= ns <= len(comps) or len(seg) < 4 + 2 * ns:
                raise JpegError("bad SOS header")
            scomps = []
            for s in range(ns):
                cs, tdta = seg[1 + 2 * s], seg[2 + 2 * s]
                for c in comps:
                    if c.cid == cs:
                        c.td, c.ta = tdta >> 4, tdta & 15
                        scomps.append(c)
                        break
                else:
                    raise JpegError("SOS references unknown component")
            if (not progressive and ns == len(comps) and geom is None
                    and (ns > 1 or (comps[0].h == 1 and comps[0].v == 1))):
                # The classic single-scan interleaved stream — the fast
                # path. Only for the FIRST scan (a later all-component SOS
                # must merge into the coefficients already decoded — the
                # C++ decode_all decides its fast path once, at the first
                # SOS, and the two backends must stay bit-identical), and
                # never for a subsampled single-component frame: T.81
                # A.2.2 makes every ns==1 scan non-interleaved (one block
                # per MCU over the component's true ceil(w/8)xceil(h/8)
                # grid), so the h*v-blocks-per-MCU geometry below would
                # desync on files libjpeg/PIL decode fine.
                return _decode_scan(buf, i, comps, qt, huff_dc, huff_ac,
                                    height, width, restart_interval)
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
            if not progressive:
                ss, se, ah, al = 0, 63, 0, 0  # sequential scans ignore A
            if geom is None:
                geom = _alloc_coefs(comps, height, width)
            i = _decode_scan_multi(buf, i, scomps, geom, huff_dc, huff_ac,
                                   restart_interval, progressive,
                                   ss, se, ah, al, height, width)
            decoded_any = True
        # else: APPn / COM / DNL etc — skipped
    if not decoded_any:
        raise JpegError("no SOS marker found")
    hmax, vmax = geom[0], geom[1]
    for c in comps:
        if c.tq not in qt:
            raise JpegError(f"missing quant table {c.tq}")
    planes = [_reconstruct(c, qt[c.tq]) for c in comps]
    return _assemble(planes, comps, hmax, vmax, height, width)


def _split_scan(buf, pos: int) -> Tuple[List[bytes], int]:
    """De-stuff the entropy-coded segment, split at restart markers.

    Returns (restart-interval chunks with 0xFF00 collapsed, absolute
    position of the marker that terminated the scan — where header
    parsing resumes for multi-scan streams)."""
    raw = np.frombuffer(buf, np.uint8, len(buf) - pos, pos)
    ff = np.flatnonzero(raw == 0xFF)
    end = len(raw)
    cuts = [0]  # chunk boundaries in `raw` (start positions)
    drop = []   # indices of stuffed 0x00 / marker bytes to delete
    for j in ff:
        if j + 1 >= len(raw):
            end = j
            break
        m = raw[j + 1]
        if m == 0x00:
            drop.append(j + 1)
        elif 0xD0 <= m <= 0xD7:
            drop.append(j)
            drop.append(j + 1)
            cuts.append(j + 2)
        else:  # a real marker terminates the scan
            end = j
            break
    chunks = []
    for k, start in enumerate(cuts):
        stop = cuts[k + 1] - 2 if k + 1 < len(cuts) else end
        seg = raw[start:stop]
        if drop:
            local = [d - start for d in drop if start <= d < stop]
            if local:
                seg = np.delete(seg, local)
        chunks.append(seg.tobytes())
    return chunks, pos + end


def _extend(v: int, s: int) -> int:
    return v - ((1 << s) - 1) if v < (1 << (s - 1)) else v


def _decode_scan(buf, pos, comps, qt, huff_dc, huff_ac, height, width,
                 restart_interval):
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcu_w, mcu_h = 8 * hmax, 8 * vmax
    mcus_x = (width + mcu_w - 1) // mcu_w
    mcus_y = (height + mcu_h - 1) // mcu_h
    for c in comps:
        c.nbx, c.nby = mcus_x * c.h, mcus_y * c.v
        c.coef = np.zeros((c.nbx * c.nby, 64), dtype=np.int32)
        if c.tq not in qt:
            raise JpegError(f"missing quant table {c.tq}")
        if c.td not in huff_dc or c.ta not in huff_ac:
            raise JpegError("missing Huffman table")

    chunks, _ = _split_scan(buf, pos)
    n_mcus = mcus_x * mcus_y
    interval = restart_interval if restart_interval else n_mcus

    # hot-loop locals
    mcu = 0
    chunk_idx = 0
    comp_tabs = [
        (c, huff_dc[c.td].lut_len, huff_dc[c.td].lut_val,
         huff_ac[c.ta].lut_len, huff_ac[c.ta].lut_val)
        for c in comps
    ]
    while mcu < n_mcus:
        if chunk_idx >= len(chunks):
            raise JpegError("truncated entropy-coded data")
        data = chunks[chunk_idx]
        chunk_idx += 1
        nbytes = len(data)
        acc = 0
        nbits = 0
        bpos = 0
        preds = [0] * len(comps)
        stop = min(mcu + interval, n_mcus)
        try:
            while mcu < stop:
                my, mx = divmod(mcu, mcus_x)
                for ci, (c, dlen, dval, alen, aval) in enumerate(comp_tabs):
                    ch, cv, nbx = c.h, c.v, c.nbx
                    coef = c.coef
                    for by in range(cv):
                        row = (my * cv + by) * nbx + mx * ch
                        for bx in range(ch):
                            blk = coef[row + bx]
                            # --- DC ---
                            while nbits < 16:
                                acc = (acc << 8) | (
                                    data[bpos] if bpos < nbytes else 0xFF)
                                bpos += 1
                                nbits += 8
                            peek = (acc >> (nbits - 16)) & 0xFFFF
                            ln = dlen[peek]
                            if ln == 0:
                                raise JpegError("bad Huffman code")
                            nbits -= int(ln)
                            s = int(dval[peek])
                            if s > 15:  # legal DC categories are 0..15
                                raise JpegError("bad DC category")
                            if s:
                                while nbits < s:
                                    acc = (acc << 8) | (
                                        data[bpos] if bpos < nbytes else 0xFF)
                                    bpos += 1
                                    nbits += 8
                                v = (acc >> (nbits - s)) & ((1 << s) - 1)
                                nbits -= s
                                diff = _extend(v, s)
                            else:
                                diff = 0
                            # int32 wrap: corrupt streams can run the DC
                            # predictor arbitrarily high (fuzz-found); the
                            # native path wraps identically
                            preds[ci] = _wrap32(preds[ci] + diff)
                            blk[0] = preds[ci]
                            # --- AC ---
                            k = 1
                            while k < 64:
                                while nbits < 16:
                                    acc = (acc << 8) | (
                                        data[bpos] if bpos < nbytes else 0xFF)
                                    bpos += 1
                                    nbits += 8
                                peek = (acc >> (nbits - 16)) & 0xFFFF
                                ln = alen[peek]
                                if ln == 0:
                                    raise JpegError("bad Huffman code")
                                nbits -= int(ln)
                                rs = int(aval[peek])
                                r, s = rs >> 4, rs & 15
                                if s == 0:
                                    if r != 15:
                                        break  # EOB
                                    k += 16  # ZRL
                                    continue
                                k += r
                                if k > 63:
                                    raise JpegError("AC run past block end")
                                while nbits < s:
                                    acc = (acc << 8) | (
                                        data[bpos] if bpos < nbytes else 0xFF)
                                    bpos += 1
                                    nbits += 8
                                v = (acc >> (nbits - s)) & ((1 << s) - 1)
                                nbits -= s
                                blk[k] = _extend(v, s)
                                k += 1
                    acc &= (1 << nbits) - 1 if nbits else 0
                mcu += 1
        except IndexError as e:  # pragma: no cover - defensive
            raise JpegError("truncated entropy-coded data") from e
        if bpos > nbytes + 4:
            raise JpegError("entropy decoder overran padded stream")

    planes = [_reconstruct(c, qt[c.tq]) for c in comps]
    return _assemble(planes, comps, hmax, vmax, height, width)


def _alloc_coefs(comps, height, width):
    """Allocate MCU-padded coefficient arrays shared by all scans of a
    multi-scan (progressive or non-interleaved sequential) stream."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcus_x = (width + 8 * hmax - 1) // (8 * hmax)
    mcus_y = (height + 8 * vmax - 1) // (8 * vmax)
    for c in comps:
        c.nbx, c.nby = mcus_x * c.h, mcus_y * c.v
        c.coef = np.zeros((c.nbx * c.nby, 64), dtype=np.int32)
    return hmax, vmax, mcus_x, mcus_y


def _wrap32(v: int) -> int:
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _ac_first_block(blk, act, band_lo, se, al, eobrun, _sym, _bits):
    """Progressive AC initial-scan block (jdphuff.c decode_mcu_AC_first).

    Also decodes the AC half of a sequential block when called with
    ``band_lo=1, se=63, al=0``: the sequential EOB symbol is the
    degenerate EOBRUN=1 case and ZRL coincides, so this is a strict
    superset of the baseline AC block coder."""
    if eobrun > 0:
        return eobrun - 1  # whole block is inside an EOB run
    k = band_lo
    while k <= se:
        rs = _sym(act)
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r != 15:
                eobrun = (1 << r) - 1  # this block is a member of the run
                if r:
                    eobrun += _bits(r)
                break
            k += 16  # ZRL
            continue
        k += r
        if k > se:
            raise JpegError("AC run past band end")
        blk[k] = _extend(_bits(s), s) << al
        k += 1
    return eobrun


def _ac_refine_block(blk, act, band_lo, se, p1, m1, eobrun, _sym, _bits):
    """Progressive AC refinement-scan block (jdphuff.c
    decode_mcu_AC_refine): one correction bit per already-nonzero
    coefficient traversed; new ±1·2^Al coefficients placed at the coded
    zero-run positions; EOB runs carry correction bits only."""
    k = band_lo
    if eobrun == 0:
        while k <= se:
            rs = _sym(act)
            r, s = rs >> 4, rs & 15
            newnz = 0
            if s == 0:
                if r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += _bits(r)
                    break  # rest of the band is EOB-run tail below
                # r == 15: ZRL — advance over 16 zero-history coefficients
            else:
                if s != 1:
                    raise JpegError("bad refinement code size")
                newnz = p1 if _bits(1) else m1
            # advance over already-nonzero coefs and r still-zero coefs,
            # appending correction bits to the nonzeros along the way
            while k <= se:
                coef = int(blk[k])
                if coef != 0:
                    if _bits(1) and (coef & p1) == 0:
                        blk[k] = coef + (p1 if coef >= 0 else m1)
                else:
                    r -= 1
                    if r < 0:
                        break  # reached the target zero coefficient
                k += 1
            if newnz:
                if k > se:
                    raise JpegError("refinement ran past band end")
                blk[k] = newnz
            k += 1
    if eobrun > 0:
        # correction bits for the nonzeros after the end-of-band position
        while k <= se:
            coef = int(blk[k])
            if coef != 0:
                if _bits(1) and (coef & p1) == 0:
                    blk[k] = coef + (p1 if coef >= 0 else m1)
            k += 1
        eobrun -= 1
    return eobrun


def _decode_scan_multi(buf, pos, scomps, geom, huff_dc, huff_ac,
                       restart_interval, progressive, ss, se, ah, al,
                       height, width):
    """Decode ONE scan of a multi-scan stream into the components'
    (already-allocated) coefficient arrays; returns the buffer position of
    the marker that ended the scan.

    Covers progressive DC/AC first + refinement scans (T.81 Annex G.2 /
    jdphuff.c) and non-interleaved sequential scans (DC-first + AC-first
    with Ah=Al=0, band 1..63). Restart intervals reset the bit reader, DC
    predictors and the EOB run, exactly as in the single-scan path."""
    hmax, vmax, mcus_x, mcus_y = geom
    ns = len(scomps)
    if progressive:
        if ss == 0 and se != 0:
            raise JpegError("bad progressive DC scan (Se != 0)")
        if ss > 0 and (ns != 1 or se < ss or se > 63):
            raise JpegError("bad progressive AC scan header")
        if ah > 13 or al > 13 or (ah and ah != al + 1):
            raise JpegError("bad successive-approximation bits")
    dc_part = ss == 0
    ac_part = se > 0
    refine = ah > 0
    for c in scomps:
        if dc_part and not refine and c.td not in huff_dc:
            raise JpegError("missing Huffman table")
        if ac_part and c.ta not in huff_ac:
            raise JpegError("missing Huffman table")
    if ns == 1:
        # non-interleaved: the unit is one block over the component's TRUE
        # block dims (not MCU-padded — dummy blocks are never coded here)
        c0 = scomps[0]
        cnbx = -(-(width * c0.h) // (hmax * 8))
        cnby = -(-(height * c0.v) // (vmax * 8))
        n_units = cnbx * cnby
    else:
        n_units = mcus_x * mcus_y

    chunks, end = _split_scan(buf, pos)
    interval = restart_interval if restart_interval else n_units
    p1, m1 = 1 << al, -1 << al
    band_lo = max(ss, 1)

    unit = 0
    chunk_idx = 0
    while unit < n_units:
        if chunk_idx >= len(chunks):
            raise JpegError("truncated entropy-coded data")
        data = chunks[chunk_idx]
        chunk_idx += 1
        nbytes = len(data)
        acc = nbits = bpos = 0
        preds = [0] * ns
        eobrun = 0

        def _bits(count):
            nonlocal acc, nbits, bpos
            while nbits < count:
                acc = (acc << 8) | (data[bpos] if bpos < nbytes else 0xFF)
                bpos += 1
                nbits += 8
            nbits -= count
            out = (acc >> nbits) & ((1 << count) - 1)
            # keep the accumulator bounded — a Python int otherwise grows
            # with every byte shifted in, turning the scan quadratic
            acc &= (1 << nbits) - 1
            return out

        def _sym(tab):
            nonlocal acc, nbits, bpos
            while nbits < 16:
                acc = (acc << 8) | (data[bpos] if bpos < nbytes else 0xFF)
                bpos += 1
                nbits += 8
            peek = (acc >> (nbits - 16)) & 0xFFFF
            ln = tab.lut_len[peek]
            if ln == 0:
                raise JpegError("bad Huffman code")
            nbits -= int(ln)
            acc &= (1 << nbits) - 1
            return int(tab.lut_val[peek])

        stop = min(unit + interval, n_units)
        while unit < stop:
            if ns == 1:
                by, bx = divmod(unit, cnbx)
                blocks = ((0, scomps[0].coef[by * scomps[0].nbx + bx]),)
            else:
                my, mx = divmod(unit, mcus_x)
                blocks = [
                    (ci, c.coef[(my * c.v + by) * c.nbx + mx * c.h + bx])
                    for ci, c in enumerate(scomps)
                    for by in range(c.v) for bx in range(c.h)
                ]
            for ci, blk in blocks:
                if dc_part:
                    if refine:
                        if _bits(1):
                            blk[0] |= p1
                    else:
                        s = _sym(huff_dc[scomps[ci].td])
                        if s > 15:  # legal DC categories are 0..15 (8-bit)
                            raise JpegError("bad DC category")
                        diff = _extend(_bits(s), s) if s else 0
                        preds[ci] = _wrap32(preds[ci] + diff)
                        blk[0] = _wrap32(preds[ci] << al)
                if ac_part:
                    act = huff_ac[scomps[ci].ta]
                    if refine:
                        eobrun = _ac_refine_block(
                            blk, act, band_lo, se, p1, m1, eobrun,
                            _sym, _bits)
                    else:
                        eobrun = _ac_first_block(
                            blk, act, band_lo, se, al, eobrun, _sym, _bits)
            unit += 1
        if bpos > nbytes + 4:
            raise JpegError("entropy decoder overran padded stream")
    return end


def _reconstruct(c: _Component, qtbl: np.ndarray) -> np.ndarray:
    """Dequantize + de-zigzag + islow IDCT one component into its plane."""
    deq = c.coef.astype(np.int64) * qtbl[None, :].astype(np.int64)
    # DC-only blocks (very common for chroma / smooth regions): the islow
    # IDCT of a DC-only block is exactly (K + 4) >> 3 in every sample —
    # skip the butterflies. Same shortcut in the C++ path (native
    # jpeg::reconstruct) keeps the backends bit-matched.
    dc_only = ~np.any(deq[:, 1:], axis=1)
    full = np.flatnonzero(~dc_only)
    pix = np.empty((deq.shape[0], 8, 8), dtype=np.int64)
    pix[dc_only] = ((deq[dc_only, 0] + 4) >> 3)[:, None, None]
    if full.size:
        blocks = np.zeros((full.size, 64), dtype=np.int64)
        blocks[:, _ZIGZAG] = deq[full]
        pix[full] = _idct_islow(blocks.reshape(-1, 8, 8))
    pix = pix.astype(np.int32) + 128
    np.clip(pix, 0, 255, out=pix)
    plane = (
        pix.reshape(c.nby, c.nbx, 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(c.nby * 8, c.nbx * 8)
    )
    return plane


def _fancy_h2(plane: np.ndarray) -> np.ndarray:
    """libjpeg h2v1 fancy (triangular) horizontal 2x upsample, integer-exact."""
    p = plane.astype(np.int32)
    left = np.empty_like(p)
    right = np.empty_like(p)
    left[:, 1:] = (3 * p[:, 1:] + p[:, :-1] + 1) >> 2
    right[:, :-1] = (3 * p[:, :-1] + p[:, 1:] + 2) >> 2
    left[:, 0] = p[:, 0]
    right[:, -1] = p[:, -1]
    out = np.empty((p.shape[0], p.shape[1] * 2), dtype=np.int32)
    out[:, 0::2] = left
    out[:, 1::2] = right
    return out


def _fancy_h2v2(plane: np.ndarray) -> np.ndarray:
    """libjpeg h2v2 fancy upsample (9:3:3:1 triangular), integer-exact."""
    p = plane.astype(np.int32)
    rows, cols = p.shape
    up = np.empty((rows * 2, cols), dtype=np.int32)  # column sums (<<2 scale)
    # output row 2r pairs row r (weight 3) with row r-1; row 2r+1 with r+1
    prev = np.vstack([p[:1], p[:-1]])
    nxt = np.vstack([p[1:], p[-1:]])
    up[0::2] = 3 * p + prev
    up[1::2] = 3 * p + nxt
    out = np.empty((rows * 2, cols * 2), dtype=np.int32)
    out[:, 2::2] = (3 * up[:, 1:] + up[:, :-1] + 8) >> 4
    out[:, 1:-1:2] = (3 * up[:, :-1] + up[:, 1:] + 7) >> 4
    out[:, 0] = (up[:, 0] * 4 + 8) >> 4
    out[:, -1] = (up[:, -1] * 4 + 7) >> 4
    return out


def _upsample(plane: np.ndarray, c: _Component, hmax: int, vmax: int,
              height: int, width: int) -> np.ndarray:
    sh = hmax // c.h if hmax % c.h == 0 else 0
    sv = vmax // c.v if vmax % c.v == 0 else 0
    cw = -(-width * c.h // hmax)   # ceil(width * h / hmax)
    chh = -(-height * c.v // vmax)
    plane = plane[:chh, :cw]
    if sh == 2 and sv == 2:
        plane = _fancy_h2v2(plane)
    elif sh == 2 and sv == 1:
        plane = _fancy_h2(plane)
    elif sh == 1 and sv == 2:
        plane = _fancy_h2(plane.T).T
    elif sh != 1 or sv != 1:
        # non-dyadic ratios (rare): nearest-neighbour replication
        ph, pw = plane.shape
        yi = np.minimum((np.arange(height) * c.v) // vmax, ph - 1)
        xi = np.minimum((np.arange(width) * c.h) // hmax, pw - 1)
        plane = plane[np.ix_(yi, xi)]
    return plane[:height, :width].astype(np.int32)


def _assemble(planes, comps, hmax, vmax, height, width) -> np.ndarray:
    if len(comps) == 1:
        return np.clip(planes[0][:height, :width], 0, 255).astype(np.uint8)
    y, cb, cr = (_upsample(p, c, hmax, vmax, height, width)
                 for p, c in zip(planes, comps))
    cb = cb - 128
    cr = cr - 128
    r = y + ((_FIX_1_40200 * cr + 32768) >> 16)
    b = y + ((_FIX_1_77200 * cb + 32768) >> 16)
    g = y + ((-_FIX_0_34414 * cb - _FIX_0_71414 * cr + 32768) >> 16)
    out = np.stack([r, g, b], axis=-1)
    np.clip(out, 0, 255, out=out)
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# encoder — baseline sequential, 4:4:4, T.81 Annex K standard tables.
# Used to re-emit CompressedImage passthroughs on bag copies and to
# synthesize camera streams in demos/tests without any image library.
# ---------------------------------------------------------------------------

# T.81 Annex K.1 example quantization tables (raster order)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32)
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32)

# T.81 Annex K.3 typical Huffman tables: (BITS[16], HUFFVAL)
_DC_LUMA_SPEC = (
    [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA_SPEC = (
    [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA_SPEC = (
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125],
    [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
     0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
     0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
     0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
     0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
     0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
     0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
     0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
     0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
     0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
     0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
     0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
     0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
     0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
     0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
     0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
     0xF9, 0xFA])
_AC_CHROMA_SPEC = (
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119],
    [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
     0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
     0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
     0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
     0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
     0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
     0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
     0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
     0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
     0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
     0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
     0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
     0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
     0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
     0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
     0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
     0xF9, 0xFA])


def _enc_table(spec):
    """(BITS, HUFFVAL) -> dict symbol -> (code, length)."""
    bits, vals = spec
    out = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _BitWriter:
    __slots__ = ("out", "acc", "nbits")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            b = (self.acc >> (self.nbits - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.put((1 << pad) - 1, pad)  # pad with 1-bits per spec


def _scaled_qtable(base: np.ndarray, quality: int) -> np.ndarray:
    quality = min(100, max(1, int(quality)))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int32)


def _fdct_quant(plane: np.ndarray, qtbl_raster: np.ndarray) -> np.ndarray:
    """(H8, W8) samples -> (nblocks, 64) quantized zigzag coefficients."""
    h, w = plane.shape
    blocks = (
        plane.reshape(h // 8, 8, w // 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 8, 8)
        .astype(np.float64) - 128.0
    )
    freq = np.einsum("xu,nxy,yv->nuv", _A, blocks, _A, optimize=True)
    flat = freq.reshape(-1, 64)[:, _ZIGZAG]  # zigzag scan
    q = qtbl_raster[_ZIGZAG].astype(np.float64)
    scaled = flat / q
    return np.trunc(scaled + np.copysign(0.5, scaled)).astype(np.int32)


def _category(v: int) -> int:
    return int(v).bit_length() if v >= 0 else int(-v).bit_length()


def encode_jpeg(img: np.ndarray, quality: int = 85,
                subsampling: str = "444") -> bytes:
    """Encode uint8 (H, W) gray or (H, W, 3) RGB as baseline JPEG.

    ``subsampling``: "444" (one chroma sample per pixel) or "420" (2x2
    box-averaged chroma, the libjpeg/cv2 ecosystem default — about half
    the bytes on camera content). Ignored for gray.

    From-spec encoder with the T.81 Annex K example tables; output decodes
    with this module, the native C++ path, and any standard decoder.
    C++ fast path when built (native.jpeg_encode — the Python bit writer
    costs seconds per 2MP frame); same tables and numerics either way.
    """
    if subsampling not in ("444", "420"):
        raise ValueError(f"subsampling must be '444' or '420', got {subsampling!r}")
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim in (2, 3) and (
            img.ndim == 2 or img.shape[-1] == 3):
        from trajectory_optimization_tpu_torch.native import jpeg_encode_native

        blob = jpeg_encode_native(img, quality, subsampling=subsampling)
        if blob is not None:
            return blob
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError("encode_jpeg expects uint8 (H,W) or (H,W,3)")
    gray = img.ndim == 2
    if not gray and img.shape[2] != 3:
        raise ValueError(f"expected 3 channels, got {img.shape[2]}")
    sub420 = subsampling == "420" and not gray
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("empty image")
    mcu = 16 if sub420 else 8
    ph, pw = -(-h // mcu) * mcu, -(-w // mcu) * mcu  # luma padded dims
    q_luma = _scaled_qtable(_Q_LUMA, quality)
    q_chroma = _scaled_qtable(_Q_CHROMA, quality)

    if gray:
        planes = [img.astype(np.float64)]
    else:
        rgb = img.astype(np.float64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
        planes = [y, cb, cr]
    coefs = []
    for ci, p in enumerate(planes):
        p = np.clip(np.floor(p + 0.5), 0, 255)
        p = np.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")
        if sub420 and ci > 0:
            # integer 2x2 box average on the rounded samples (bias +2;
            # the C++ path computes the same samples — streams then agree
            # to the usual encoder contract: decode within ±1 count)
            ip = p.astype(np.int64)
            p = ((ip[0::2, 0::2] + ip[0::2, 1::2]
                  + ip[1::2, 0::2] + ip[1::2, 1::2] + 2) >> 2).astype(np.float64)
        coefs.append(_fdct_quant(p, q_luma if ci == 0 else q_chroma))

    dc_tabs = [_enc_table(_DC_LUMA_SPEC), _enc_table(_DC_CHROMA_SPEC)]
    ac_tabs = [_enc_table(_AC_LUMA_SPEC), _enc_table(_AC_CHROMA_SPEC)]

    out = bytearray(b"\xff\xd8")  # SOI
    out += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"

    def seg(marker, payload):
        out.extend((0xFF, marker))
        out.extend(((len(payload) + 2) >> 8, (len(payload) + 2) & 0xFF))
        out.extend(payload)

    zz_q_luma = q_luma[_ZIGZAG]
    seg(0xDB, bytes([0x00]) + bytes(int(v) for v in zz_q_luma))
    if not gray:
        seg(0xDB, bytes([0x01]) + bytes(int(v) for v in q_chroma[_ZIGZAG]))
    ncomp = 1 if gray else 3
    sof = bytearray([8, h >> 8, h & 0xFF, w >> 8, w & 0xFF, ncomp])
    for c in range(ncomp):
        hv = 0x22 if (sub420 and c == 0) else 0x11
        sof += bytes([c + 1, hv, 0 if c == 0 else 1])
    seg(0xC0, bytes(sof))
    for tc, th, spec in [(0, 0, _DC_LUMA_SPEC), (1, 0, _AC_LUMA_SPEC)] + (
            [] if gray else [(0, 1, _DC_CHROMA_SPEC), (1, 1, _AC_CHROMA_SPEC)]):
        bits, vals = spec
        seg(0xC4, bytes([(tc << 4) | th]) + bytes(bits) + bytes(vals))
    sos = bytearray([ncomp])
    for c in range(ncomp):
        t = 0 if c == 0 else 1
        sos += bytes([c + 1, (t << 4) | t])
    sos += bytes([0, 63, 0])
    seg(0xDA, bytes(sos))

    bw = _BitWriter()
    preds = [0] * ncomp

    def emit_block(blk, ci):
        t = 0 if ci == 0 else 1
        dct, act = dc_tabs[t], ac_tabs[t]
        dc = int(blk[0])
        diff = dc - preds[ci]
        preds[ci] = dc
        s = _category(diff)
        code, ln = dct[s]
        bw.put(code, ln)
        if s:
            bw.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        run = 0
        nz = np.flatnonzero(blk[1:])
        last_nz = (nz[-1] + 1) if nz.size else 0
        k = 1
        while k <= last_nz:
            v = int(blk[k])
            if v == 0:
                run += 1
                k += 1
                continue
            while run > 15:
                code, ln = act[0xF0]  # ZRL
                bw.put(code, ln)
                run -= 16
            s = _category(v)
            code, ln = act[(run << 4) | s]
            bw.put(code, ln)
            bw.put(v if v >= 0 else v + (1 << s) - 1, s)
            run = 0
            k += 1
        if last_nz < 63:
            code, ln = act[0x00]  # EOB
            bw.put(code, ln)

    if sub420:
        # MCU = 2x2 Y blocks (row-major within the MCU) + Cb + Cr
        mx, my = pw // 16, ph // 16
        nbx_y = pw // 8
        for m in range(mx * my):
            mr, mc = divmod(m, mx)
            for by in range(2):
                for bx in range(2):
                    emit_block(coefs[0][(2 * mr + by) * nbx_y + 2 * mc + bx], 0)
            emit_block(coefs[1][m], 1)
            emit_block(coefs[2][m], 2)
    else:
        for bi in range(coefs[0].shape[0]):
            for ci in range(ncomp):
                emit_block(coefs[ci][bi], ci)
    bw.flush()
    out += bw.out
    out += b"\xff\xd9"  # EOI
    return bytes(out)
