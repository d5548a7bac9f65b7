// Native host-side kernels for trajectory_optimization_tpu.
//
// The reference delegates cloud downsampling to PCL's C++ VoxelGrid nodelet
// (launch/voxels_filtering.launch); this is the equivalent native component
// for the scene-bus filter node, exposed via a C ABI and loaded with ctypes
// (no pybind11 in this environment). Build: `make` in this directory.
//
// All functions are thread-safe (no global state) and operate on row-major
// float32 buffers owned by the caller.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <unordered_map>
#include <vector>

namespace {

struct VoxelKey {
  int64_t x, y, z;
  bool operator==(const VoxelKey &o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct VoxelKeyHash {
  size_t operator()(const VoxelKey &k) const {
    // large-prime mix, same family as the device-side hash
    uint64_t h = static_cast<uint64_t>(k.x) * 73856093ULL;
    h ^= static_cast<uint64_t>(k.y) * 19349663ULL;
    h ^= static_cast<uint64_t>(k.z) * 83492791ULL;
    return static_cast<size_t>(h);
  }
};

struct Accum {
  double sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int64_t count = 0;
};

}  // namespace

extern "C" {

// Centroid voxel-grid downsample (PCL VoxelGrid semantics).
//   pts:      n x dim float32 (dim in [3, 8]; extra columns averaged too)
//   leaf:     voxel edge length
//   use_z/zmin/zmax: optional z pass-through filter
//   out:      caller buffer, capacity max_out x dim
// Returns the number of output points (<= max_out), or -1 on bad args.
int64_t voxel_downsample(const float *pts, int64_t n, int32_t dim, float leaf,
                         int32_t use_z, float zmin, float zmax, float *out,
                         int64_t max_out) {
  if (dim < 3 || dim > 8 || leaf <= 0.0f || n < 0) return -1;
  std::unordered_map<VoxelKey, Accum, VoxelKeyHash> grid;
  grid.reserve(static_cast<size_t>(n / 4 + 16));
  const double inv_leaf = 1.0 / static_cast<double>(leaf);

  for (int64_t i = 0; i < n; ++i) {
    const float *p = pts + i * dim;
    if (use_z && (p[2] < zmin || p[2] > zmax)) continue;
    if (!std::isfinite(p[0]) || !std::isfinite(p[1]) || !std::isfinite(p[2]))
      continue;
    VoxelKey key{static_cast<int64_t>(std::floor(p[0] * inv_leaf)),
                 static_cast<int64_t>(std::floor(p[1] * inv_leaf)),
                 static_cast<int64_t>(std::floor(p[2] * inv_leaf))};
    Accum &a = grid[key];
    for (int32_t c = 0; c < dim; ++c) a.sum[c] += p[c];
    a.count += 1;
  }

  int64_t m = 0;
  for (const auto &kv : grid) {
    if (m >= max_out) break;
    const Accum &a = kv.second;
    float *o = out + m * dim;
    for (int32_t c = 0; c < dim; ++c)
      o[c] = static_cast<float>(a.sum[c] / static_cast<double>(a.count));
    ++m;
  }
  return m;
}

// Hard frustum cull: camera-frame points -> 0/1 mask.
// Semantics match ops.geometry.frustum_cull / reference src/tools.py:176-187.
void frustum_cull_mask(const float *pts, int64_t n, const float *K3x3,
                       float img_w, float img_h, float min_dist, float max_dist,
                       uint8_t *mask_out) {
  const float fx = K3x3[0], cx = K3x3[2], fy = K3x3[4], cy = K3x3[5];
  for (int64_t i = 0; i < n; ++i) {
    const float *p = pts + i * 3;
    const float z = p[2];
    bool ok = (z > min_dist) && (z < max_dist);
    if (ok) {
      const float u = (fx * p[0] + cx * z) / z;
      const float v = (fy * p[1] + cy * z) / z;
      ok = (u > 1.0f) && (u < img_w - 1.0f) && (v > 1.0f) && (v < img_h - 1.0f);
    }
    mask_out[i] = ok ? 1 : 0;
  }
}

// Binary occupancy grid (pc_to_voxel parity, src/pointcloud_utils.py:279-288).
// grid_out must hold dx*dy*dz uint8, zero-initialized by this function.
void occupancy_grid(const float *pts, int64_t n, float resolution, float x0,
                    float x1, float y0, float y1, float z0, float z1,
                    uint8_t *grid_out) {
  const int64_t dx = static_cast<int64_t>((x1 - x0) / resolution);
  const int64_t dy = static_cast<int64_t>((y1 - y0) / resolution);
  const int64_t dz = static_cast<int64_t>(std::lround((z1 - z0) / resolution));
  std::memset(grid_out, 0, static_cast<size_t>(dx * dy * dz));
  for (int64_t i = 0; i < n; ++i) {
    const float *p = pts + i * 3;
    if (p[0] < x0 || p[0] >= x1 || p[1] < y0 || p[1] >= y1 || p[2] < z0 ||
        p[2] >= z1)
      continue;
    const int64_t ix = static_cast<int64_t>((p[0] - x0) / resolution);
    const int64_t iy = static_cast<int64_t>((p[1] - y0) / resolution);
    const int64_t iz = static_cast<int64_t>((p[2] - z0) / resolution);
    if (ix < dx && iy < dy && iz < dz) grid_out[(ix * dy + iy) * dz + iz] = 1;
  }
}

// LZ4 *block* decoder (format per the public LZ4 block spec): sequences of
// [token][literals][2-byte LE match offset][ext match len]. Written from the
// spec for decoding lz4-compressed rosbag chunks (the reference's session
// bag is lz4, launch/rosbag_info.txt). Decodes into dst AT
// dst_pos so block-DEPENDENT frames (matches reaching into prior blocks'
// output) work by construction. Returns the new dst_pos, or -1 on malformed
// input / insufficient dst capacity.
int64_t lz4_block_decode(const uint8_t *src, int64_t src_len, uint8_t *dst,
                         int64_t dst_pos, int64_t dst_cap) {
  int64_t ip = 0, op = dst_pos;
  while (ip < src_len) {
    const uint8_t token = src[ip++];
    // literal run
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= src_len) return -1;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > src_len || op + lit > dst_cap) return -1;
    std::memcpy(dst + op, src + ip, static_cast<size_t>(lit));
    ip += lit;
    op += lit;
    if (ip == src_len) break;  // last sequence carries literals only
    // match
    if (ip + 2 > src_len) return -1;
    const int64_t offset = src[ip] | (src[ip + 1] << 8);
    ip += 2;
    if (offset == 0 || offset > op) return -1;
    int64_t mlen = (token & 0x0F);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= src_len) return -1;
        b = src[ip++];
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > dst_cap) return -1;
    const uint8_t *m = dst + op - offset;
    if (offset >= mlen) {  // disjoint: bulk copy
      std::memcpy(dst + op, m, static_cast<size_t>(mlen));
    } else {  // overlapping match replicates a pattern byte-by-byte
      for (int64_t k = 0; k < mlen; ++k) dst[op + k] = m[k];
    }
    op += mlen;
  }
  return op;
}

// LZ4 *block* encoder: greedy hash-table matcher in the shape of the
// reference LZ4_compress_default (64K-entry hash of 4-byte prefixes,
// skip-acceleration over incompressible runs, backward match extension),
// honoring the spec's end-of-block rules: the last 5 bytes stay literal,
// no match starts within the last 12 bytes. Output is spec-conformant but
// NOT byte-identical to liblz4 (greedy choices differ slightly); it IS
// bit-identical to the pure-Python mirror bus/lz4.py::_encode_block_py
// (same hash, same probe order, same acceleration schedule) so tests pin
// backend agreement. Little-endian hosts only (like the rest of the bag
// codec — bus/codec.py guards big-endian loudly). Returns the compressed
// size, or -1 when the output would not fit cap — callers hand the block
// to the stored path (callers pass cap = n-1, so "doesn't fit" doubles as
// "didn't shrink").
int64_t lz4_block_encode(const uint8_t *src, int64_t n, uint8_t *dst,
                         int64_t cap) {
  int64_t op = 0;
  auto emit_ext = [&](int64_t len) -> bool {  // the 15+ length extension
    while (len >= 255) {
      if (op >= cap) return false;
      dst[op++] = 255;
      len -= 255;
    }
    if (op >= cap) return false;
    dst[op++] = static_cast<uint8_t>(len);
    return true;
  };
  auto read32 = [&](int64_t i) -> uint32_t {
    uint32_t v;
    std::memcpy(&v, src + i, 4);
    return v;
  };
  auto emit_seq = [&](int64_t lit_from, int64_t lit_n, int64_t offset,
                      int64_t ml) -> bool {  // ml = match len - 4, or -1
    if (op >= cap) return false;
    const int64_t tok_pos = op++;
    uint8_t tok = lit_n >= 15 ? 0xF0 : static_cast<uint8_t>(lit_n << 4);
    if (lit_n >= 15 && !emit_ext(lit_n - 15)) return false;
    if (op + lit_n > cap) return false;
    std::memcpy(dst + op, src + lit_from, static_cast<size_t>(lit_n));
    op += lit_n;
    if (ml >= 0) {
      if (op + 2 > cap) return false;
      dst[op++] = static_cast<uint8_t>(offset & 0xFF);
      dst[op++] = static_cast<uint8_t>(offset >> 8);
      if (ml >= 15) {
        tok |= 15;
        if (!emit_ext(ml - 15)) return false;
      } else {
        tok |= static_cast<uint8_t>(ml);
      }
    }
    dst[tok_pos] = tok;
    return true;
  };

  int64_t anchor = 0;
  if (n >= 13) {  // LZ4_minLength: shorter inputs are all-literal
    const int64_t matchlimit = n - 5;  // matches may run up to here
    std::vector<int32_t> table(1 << 16, -1);
    int64_t ip = 0;
    int64_t search_nb = 1 << 6;  // acceleration 1, skipTrigger 6
    while (ip <= n - 13) {  // conservative 12-byte-tail rule for starts
      const uint32_t v = read32(ip);
      const uint32_t h =
          static_cast<uint32_t>(v * UINT32_C(2654435761)) >> 16;
      const int64_t ref = table[h];
      table[h] = static_cast<int32_t>(ip);
      if (ref >= 0 && ip - ref <= 65535 && read32(ref) == v) {
        int64_t mip = ip, mref = ref;
        while (mip > anchor && mref > 0 && src[mip - 1] == src[mref - 1]) {
          --mip;
          --mref;
        }
        int64_t mlen = 4;
        while (mip + mlen < matchlimit && src[mref + mlen] == src[mip + mlen])
          ++mlen;
        if (!emit_seq(anchor, mip - anchor, mip - mref, mlen - 4)) return -1;
        ip = mip + mlen;
        anchor = ip;
        search_nb = 1 << 6;
      } else {
        ip += search_nb >> 6;
        ++search_nb;
      }
    }
  }
  if (!emit_seq(anchor, n - anchor, 0, -1)) return -1;
  return op;
}

// PNG scanline unfiltering (RFC 2083 §6): the serial Sub/Average/Paeth
// recurrences are a per-byte Python loop in bus/png.py (~seconds per 16-bit
// depth frame); this is the native fast path behind it. raw holds
// height*(stride+1) bytes (filter byte + scanline); out receives
// height*stride. Returns 0, or -1 on an unknown filter type.
int32_t png_unfilter(const uint8_t *raw, int64_t height, int64_t stride,
                     int32_t bpp, uint8_t *out) {
  if (height <= 0 || stride <= 0 || bpp <= 0) return -1;
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t f = raw[r * (stride + 1)];
    const uint8_t *in = raw + r * (stride + 1) + 1;
    uint8_t *cur = out + r * stride;
    const uint8_t *up = r > 0 ? cur - stride : nullptr;
    switch (f) {
      case 0:
        std::memcpy(cur, in, static_cast<size_t>(stride));
        break;
      case 1:  // Sub
        for (int64_t x = 0; x < stride; ++x)
          cur[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:  // Up
        if (up) {
          for (int64_t x = 0; x < stride; ++x)
            cur[x] = static_cast<uint8_t>(in[x] + up[x]);
        } else {
          std::memcpy(cur, in, static_cast<size_t>(stride));
        }
        break;
      case 3:  // Average
        for (int64_t x = 0; x < stride; ++x) {
          const int left = x >= bpp ? cur[x - bpp] : 0;
          const int above = up ? up[x] : 0;
          cur[x] = static_cast<uint8_t>(in[x] + ((left + above) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = static_cast<uint8_t>(in[x] + pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Baseline JPEG (ITU-T T.81) decoder — native fast path for
// sensor_msgs/CompressedImage payloads (the reference bag's six camera
// streams, launch/rosbag_info.txt:15). Written from the spec; numerics are
// pinned to bus/jpeg.py (the NumPy fallback): libjpeg 16.16 fixed-point
// YCbCr->RGB, triangular "fancy" factor-2 chroma upsampling, fixed-point
// islow IDCT (jidctint.c) — integer end to end, bit-identical to both the
// NumPy path and libjpeg/PIL. Baseline sequential only (SOF0/SOF1, 8-bit, 1 or 3
// components, restart markers); progressive returns "unsupported" and the
// caller keeps the compressed passthrough.

namespace jpeg {

constexpr int kErrMalformed = -1;
constexpr int kErrUnsupported = -2;
constexpr int kErrCapacity = -3;

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huff {
  // 16-bit peek LUT, one load per symbol: entry = (code_len << 8) | value
  // (code_len == 0 marks an invalid prefix)
  std::vector<uint16_t> lut;
  bool valid = false;
  int build(const uint8_t *counts, const uint8_t *values) {
    lut.assign(1 << 16, 0);
    uint32_t code = 0;
    int k = 0;
    for (int length = 1; length <= 16; ++length) {
      for (int i = 0; i < counts[length - 1]; ++i) {
        if (code >= (1u << length)) return kErrMalformed;
        const uint32_t lo = code << (16 - length);
        const uint32_t hi = lo + (1u << (16 - length));
        const uint16_t entry =
            static_cast<uint16_t>((length << 8) | values[k]);
        for (uint32_t c = lo; c < hi; ++c) lut[c] = entry;
        ++code;
        ++k;
      }
      code <<= 1;
    }
    valid = true;
    return 0;
  }
};

struct Component {
  int cid = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int nbx = 0, nby = 0;
  std::vector<int32_t> coef;  // (nbx*nby) x 64, zigzag order
};

// Chunk bit reader shared by the multi-scan decode paths: bulk 32-bit
// refill over the de-stuffed chunk, 1-bits past the end per T.81.
struct BitRd {
  const uint8_t *d = nullptr;
  int64_t nb = 0, bpos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  void reset(const std::vector<uint8_t> &data) {
    d = data.data();
    nb = static_cast<int64_t>(data.size());
    bpos = 0;
    acc = 0;
    nbits = 0;
  }
  inline void refill(int need) {
    while (nbits < need) {
      if (bpos + 4 <= nb && nbits <= 31) {
        acc = (acc << 32) | (static_cast<uint64_t>(d[bpos]) << 24) |
              (static_cast<uint64_t>(d[bpos + 1]) << 16) |
              (static_cast<uint64_t>(d[bpos + 2]) << 8) |
              static_cast<uint64_t>(d[bpos + 3]);
        bpos += 4;
        nbits += 32;
      } else {
        acc = (acc << 8) | (bpos < nb ? d[bpos] : 0xFF);
        ++bpos;
        nbits += 8;
      }
    }
  }
  inline uint32_t bits(int count) {  // count in 1..16
    refill(count);
    nbits -= count;
    return static_cast<uint32_t>((acc >> nbits) & ((1u << count) - 1));
  }
  inline int sym(const struct Huff &t);  // -1 on invalid prefix
};

inline int BitRd::sym(const Huff &t) {
  refill(16);
  const uint32_t peek = (acc >> (nbits - 16)) & 0xFFFF;
  const uint16_t e = t.lut[peek];
  const int ln = e >> 8;
  if (ln == 0) return -1;
  nbits -= ln;
  return e & 0xFF;
}

struct Decoder {
  const uint8_t *buf;
  int64_t n;
  int32_t qt[4][64];
  bool qt_ok[4] = {false, false, false, false};
  Huff hdc[4], hac[4];
  Component comps[3];
  int ncomp = 0;
  int height = 0, width = 0;
  int restart_interval = 0;
  int64_t scan_pos = -1;
  // multi-scan state (progressive / non-interleaved sequential)
  bool progressive = false;
  bool sof_seen = false;
  int scan_ns = 0, scan_comp[3] = {0, 0, 0};
  int scan_ss = 0, scan_se = 63, scan_ah = 0, scan_al = 0;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;

  Decoder(const uint8_t *b, int64_t len) : buf(b), n(len) {}

  int u16(int64_t i) const { return (buf[i] << 8) | buf[i + 1]; }

  // Parse headers up to (and including) the FIRST SOS. Returns 0 or kErr*.
  int parse_headers() {
    if (n < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return kErrMalformed;
    const int rc = parse_from(2);
    if (rc == 2) return kErrMalformed;  // EOI / end of data before any SOS
    return rc;
  }

  // Process marker segments starting at i. Returns 0 when an SOS was
  // parsed (scan_pos / scan_* filled), 2 on EOI or end of data, else kErr*.
  int parse_from(int64_t i) {
    while (i < n) {
      if (buf[i] != 0xFF) return kErrMalformed;
      while (i < n && buf[i] == 0xFF) ++i;  // fill bytes
      if (i >= n) return kErrMalformed;
      const int marker = buf[i++];
      if (marker == 0xD9) return 2;  // EOI (error for the caller if no scan)
      if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      if (i + 2 > n) return kErrMalformed;
      const int seglen = u16(i);
      if (seglen < 2 || i + seglen > n) return kErrMalformed;
      const uint8_t *seg = buf + i + 2;
      const int slen = seglen - 2;
      i += seglen;

      if (marker == 0xDB) {  // DQT
        int p = 0;
        while (p < slen) {
          const int pq = seg[p] >> 4, tq = seg[p] & 15;
          ++p;
          if (tq > 3) return kErrMalformed;
          if (pq == 0) {
            if (p + 64 > slen) return kErrMalformed;
            for (int k = 0; k < 64; ++k) qt[tq][k] = seg[p + k];
            p += 64;
          } else if (pq == 1) {
            if (p + 128 > slen) return kErrMalformed;
            for (int k = 0; k < 64; ++k)
              qt[tq][k] = (seg[p + 2 * k] << 8) | seg[p + 2 * k + 1];
            p += 128;
          } else {
            return kErrMalformed;
          }
          qt_ok[tq] = true;
        }
      } else if (marker == 0xC4) {  // DHT
        int p = 0;
        while (p + 17 <= slen) {
          const int tc = seg[p] >> 4, th = seg[p] & 15;
          if (th > 3 || tc > 1) return kErrMalformed;
          int total = 0;
          for (int k = 0; k < 16; ++k) total += seg[p + 1 + k];
          if (p + 17 + total > slen) return kErrMalformed;
          Huff &t = tc == 0 ? hdc[th] : hac[th];
          const int rc = t.build(seg + p + 1, seg + p + 17);
          if (rc) return rc;
          p += 17 + total;
        }
      } else if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
        if (sof_seen || slen < 6) return kErrMalformed;  // SOF0/1/2
        sof_seen = true;
        progressive = marker == 0xC2;
        if (seg[0] != 8) return kErrUnsupported;
        height = (seg[1] << 8) | seg[2];
        width = (seg[3] << 8) | seg[4];
        ncomp = seg[5];
        if (height == 0 || width == 0) return kErrUnsupported;  // DNL
        if (ncomp != 1 && ncomp != 3) return kErrUnsupported;
        if (slen < 6 + 3 * ncomp) return kErrMalformed;
        for (int c = 0; c < ncomp; ++c) {
          comps[c].cid = seg[6 + 3 * c];
          comps[c].h = seg[7 + 3 * c] >> 4;
          comps[c].v = seg[7 + 3 * c] & 15;
          comps[c].tq = seg[8 + 3 * c];
          if (comps[c].h < 1 || comps[c].h > 4 || comps[c].v < 1 ||
              comps[c].v > 4 || comps[c].tq > 3)
            return kErrMalformed;
        }
      } else if (marker >= 0xC3 && marker <= 0xCF && marker != 0xC4 &&
                 marker != 0xC8 && marker != 0xCC) {
        return kErrUnsupported;  // lossless / hierarchical / arithmetic
      } else if (marker == 0xDD) {  // DRI
        if (slen < 2) return kErrMalformed;
        restart_interval = (seg[0] << 8) | seg[1];
      } else if (marker == 0xDA) {  // SOS
        if (!sof_seen || slen < 1) return kErrMalformed;
        const int ns = seg[0];
        if (ns < 1 || ns > ncomp || slen < 4 + 2 * ns) return kErrMalformed;
        for (int s = 0; s < ns; ++s) {
          const int cs = seg[1 + 2 * s], tdta = seg[2 + 2 * s];
          // table ids index the 4-entry hdc/hac arrays — reject out-of-range
          if ((tdta >> 4) > 3 || (tdta & 15) > 3) return kErrMalformed;
          bool found = false;
          for (int c = 0; c < ncomp; ++c) {
            if (comps[c].cid == cs) {
              comps[c].td = tdta >> 4;
              comps[c].ta = tdta & 15;
              scan_comp[s] = c;
              found = true;
              break;
            }
          }
          if (!found) return kErrMalformed;
        }
        scan_ns = ns;
        if (progressive) {
          scan_ss = seg[1 + 2 * ns];
          scan_se = seg[2 + 2 * ns];
          scan_ah = seg[3 + 2 * ns] >> 4;
          scan_al = seg[3 + 2 * ns] & 15;
        } else {
          scan_ss = 0; scan_se = 63; scan_ah = 0; scan_al = 0;
        }
        scan_pos = i;
        return 0;
      }
      // else APPn/COM/DNL skipped
    }
    return 2;  // ran off the end of the buffer without another scan
  }

  // De-stuff the entropy-coded segment starting at pos, split at restart
  // markers. *end gets the position of the marker that terminated the
  // scan (where header parsing resumes for multi-scan streams).
  int split_scan(int64_t pos, std::vector<std::vector<uint8_t>> &chunks,
                 int64_t *end) const {
    chunks.clear();
    chunks.emplace_back();
    int64_t i = pos;
    while (i < n) {
      const uint8_t b = buf[i];
      if (b == 0xFF) {
        const uint8_t m = (i + 1 < n) ? buf[i + 1] : 0xD9;
        if (m == 0x00) {
          chunks.back().push_back(0xFF);
          i += 2;
          continue;
        }
        if (m >= 0xD0 && m <= 0xD7) {
          chunks.emplace_back();
          i += 2;
          continue;
        }
        break;  // real marker terminates the scan
      }
      chunks.back().push_back(b);
      ++i;
    }
    if (end) *end = i;
    return 0;
  }

  static int32_t extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - ((1 << s) - 1) : v;
  }

  // Allocate MCU-padded coefficient planes + frame geometry (members).
  void alloc_coefs() {
    hmax = vmax = 1;
    for (int c = 0; c < ncomp; ++c) {
      hmax = comps[c].h > hmax ? comps[c].h : hmax;
      vmax = comps[c].v > vmax ? comps[c].v : vmax;
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component &cc = comps[c];
      cc.nbx = mcus_x * cc.h;
      cc.nby = mcus_y * cc.v;
      cc.coef.assign(static_cast<size_t>(cc.nbx) * cc.nby * 64, 0);
    }
  }

  // The classic single-scan interleaved sequential fast path.
  int decode_scan() {
    alloc_coefs();
    for (int c = 0; c < ncomp; ++c) {
      Component &cc = comps[c];
      if (!qt_ok[cc.tq] || !hdc[cc.td].valid || !hac[cc.ta].valid)
        return kErrMalformed;
    }
    std::vector<std::vector<uint8_t>> chunks;
    split_scan(scan_pos, chunks, nullptr);
    const int64_t n_mcus = static_cast<int64_t>(mcus_x) * mcus_y;
    const int64_t interval = restart_interval ? restart_interval : n_mcus;

    int64_t mcu = 0;
    size_t chunk_idx = 0;
    while (mcu < n_mcus) {
      if (chunk_idx >= chunks.size()) return kErrMalformed;
      const std::vector<uint8_t> &data = chunks[chunk_idx++];
      const int64_t nbytes = static_cast<int64_t>(data.size());
      uint64_t acc = 0;
      int nbits = 0;
      int64_t bpos = 0;
      // int64 accumulate + wrapping cast: corrupt streams can run the
      // DC predictor past int32 (fuzz-found); matches the NumPy path
      int64_t preds[3] = {0, 0, 0};
      // bulk refill: the chunk is already de-stuffed, so 4 bytes load at
      // once except near the end (pad with 1-bits per T.81 past EOS)
      auto refill = [&](int need) {
        while (nbits < need) {
          if (bpos + 4 <= nbytes && nbits <= 31) {
            acc = (acc << 32) |
                  (static_cast<uint64_t>(data[bpos]) << 24) |
                  (static_cast<uint64_t>(data[bpos + 1]) << 16) |
                  (static_cast<uint64_t>(data[bpos + 2]) << 8) |
                  static_cast<uint64_t>(data[bpos + 3]);
            bpos += 4;
            nbits += 32;
          } else {
            acc = (acc << 8) | (bpos < nbytes ? data[bpos] : 0xFF);
            ++bpos;
            nbits += 8;
          }
        }
      };
      const int64_t stop = mcu + interval < n_mcus ? mcu + interval : n_mcus;
      while (mcu < stop) {
        const int64_t my = mcu / mcus_x, mx = mcu % mcus_x;
        for (int ci = 0; ci < ncomp; ++ci) {
          Component &c = comps[ci];
          const uint16_t *dlut = hdc[c.td].lut.data();
          const uint16_t *alut = hac[c.ta].lut.data();
          for (int by = 0; by < c.v; ++by) {
            const int64_t row = (my * c.v + by) * c.nbx + mx * c.h;
            for (int bx = 0; bx < c.h; ++bx) {
              int32_t *blk = c.coef.data() + (row + bx) * 64;
              // --- DC ---
              refill(16);
              uint32_t peek = (acc >> (nbits - 16)) & 0xFFFF;
              uint16_t entry = dlut[peek];
              int ln = entry >> 8;
              if (ln == 0) return kErrMalformed;
              nbits -= ln;
              const int s = entry & 0xFF;
              // legal DC categories are 0..15; larger table values would
              // shift past the accumulator (UB) — reject like bus/jpeg.py
              if (s > 15) return kErrMalformed;
              int32_t diff = 0;
              if (s) {
                refill(s);
                const int v =
                    static_cast<int>((acc >> (nbits - s)) & ((1u << s) - 1));
                nbits -= s;
                diff = extend(v, s);
              }
              preds[ci] = static_cast<int32_t>(
                  static_cast<uint32_t>(preds[ci] + diff));
              blk[0] = static_cast<int32_t>(preds[ci]);
              // --- AC ---
              int k = 1;
              while (k < 64) {
                refill(16);
                peek = (acc >> (nbits - 16)) & 0xFFFF;
                entry = alut[peek];
                ln = entry >> 8;
                if (ln == 0) return kErrMalformed;
                nbits -= ln;
                const int rs = entry & 0xFF;
                const int r = rs >> 4, sa = rs & 15;
                if (sa == 0) {
                  if (r != 15) break;  // EOB
                  k += 16;             // ZRL
                  continue;
                }
                k += r;
                if (k > 63) return kErrMalformed;
                refill(sa);
                const int v =
                    static_cast<int>((acc >> (nbits - sa)) & ((1u << sa) - 1));
                nbits -= sa;
                blk[k] = extend(v, sa);
                ++k;
              }
            }
          }
          acc &= nbits ? ((1ull << nbits) - 1) : 0;
        }
        ++mcu;
      }
      if (bpos > nbytes + 4) return kErrMalformed;
    }
    return 0;
  }

  // --- multi-scan paths (progressive / non-interleaved sequential) ---
  // Mirrors bus/jpeg.py::_decode_scan_multi (the jdphuff.c algorithms);
  // the two backends stay bit-identical — pinned in tests.

  // Progressive AC initial-scan block (jdphuff.c decode_mcu_AC_first);
  // with band 1..63 / al=0 this is also the sequential AC block coder.
  int ac_first_block(int32_t *blk, const Huff &act, int band_lo, int se,
                     int al, int64_t *eobrun, BitRd &br) {
    if (*eobrun > 0) {
      --*eobrun;  // whole block is inside an EOB run
      return 0;
    }
    int k = band_lo;
    while (k <= se) {
      const int rs = br.sym(act);
      if (rs < 0) return kErrMalformed;
      const int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r != 15) {
          *eobrun = (int64_t{1} << r) - 1;  // this block is run member 0
          if (r) *eobrun += br.bits(r);
          break;
        }
        k += 16;  // ZRL
        continue;
      }
      k += r;
      if (k > se) return kErrMalformed;
      blk[k] = extend(static_cast<int>(br.bits(s)), s) << al;
      ++k;
    }
    return 0;
  }

  // Progressive AC refinement-scan block (jdphuff.c decode_mcu_AC_refine).
  int ac_refine_block(int32_t *blk, const Huff &act, int band_lo, int se,
                      int32_t p1, int32_t m1, int64_t *eobrun, BitRd &br) {
    int k = band_lo;
    if (*eobrun == 0) {
      while (k <= se) {
        const int rs = br.sym(act);
        if (rs < 0) return kErrMalformed;
        int r = rs >> 4;
        const int s = rs & 15;
        int32_t newnz = 0;
        if (s == 0) {
          if (r != 15) {
            *eobrun = int64_t{1} << r;
            if (r) *eobrun += br.bits(r);
            break;  // rest of the band is the EOB-run tail below
          }
          // r == 15: ZRL — advance over 16 zero-history coefficients
        } else {
          if (s != 1) return kErrMalformed;  // new coef size must be 1
          newnz = br.bits(1) ? p1 : m1;
        }
        // advance over already-nonzero coefs and r still-zero coefs,
        // appending correction bits to the nonzeros along the way
        while (k <= se) {
          int32_t &coef = blk[k];
          if (coef != 0) {
            if (br.bits(1) && (coef & p1) == 0) coef += coef >= 0 ? p1 : m1;
          } else {
            if (--r < 0) break;  // reached the target zero coefficient
          }
          ++k;
        }
        if (newnz) {
          if (k > se) return kErrMalformed;
          blk[k] = newnz;
        }
        ++k;
      }
    }
    if (*eobrun > 0) {
      // correction bits for nonzeros after the end-of-band position
      for (; k <= se; ++k) {
        int32_t &coef = blk[k];
        if (coef != 0) {
          if (br.bits(1) && (coef & p1) == 0) coef += coef >= 0 ? p1 : m1;
        }
      }
      --*eobrun;
    }
    return 0;
  }

  // Decode ONE scan of a multi-scan stream into the (already-allocated)
  // coefficient planes; *end_out gets the terminating-marker position.
  int decode_scan_multi(int64_t pos, int64_t *end_out) {
    const int ns = scan_ns;
    const int ss = scan_ss, se = scan_se, ah = scan_ah, al = scan_al;
    if (progressive) {
      if (ss == 0 && se != 0) return kErrMalformed;
      if (ss > 0 && (ns != 1 || se < ss || se > 63)) return kErrMalformed;
      if (ah > 13 || al > 13 || (ah && ah != al + 1)) return kErrMalformed;
    }
    const bool dc_part = ss == 0;
    const bool ac_part = se > 0;
    const bool refine = ah > 0;
    for (int s = 0; s < ns; ++s) {
      const Component &c = comps[scan_comp[s]];
      if (dc_part && !refine && !hdc[c.td].valid) return kErrMalformed;
      if (ac_part && !hac[c.ta].valid) return kErrMalformed;
    }
    int cnbx = 0, cnby = 0;
    int64_t n_units;
    if (ns == 1) {
      // non-interleaved: the unit is one block over the component's TRUE
      // block dims (not MCU-padded — dummy blocks are never coded here)
      const Component &c = comps[scan_comp[0]];
      cnbx = (width * c.h + hmax * 8 - 1) / (hmax * 8);
      cnby = (height * c.v + vmax * 8 - 1) / (vmax * 8);
      n_units = static_cast<int64_t>(cnbx) * cnby;
    } else {
      n_units = static_cast<int64_t>(mcus_x) * mcus_y;
    }
    std::vector<std::vector<uint8_t>> chunks;
    split_scan(pos, chunks, end_out);
    const int64_t interval = restart_interval ? restart_interval : n_units;
    const int32_t p1 = 1 << al, m1 = -(1 << al);
    const int band_lo = ss > 1 ? ss : 1;

    int64_t unit = 0;
    size_t chunk_idx = 0;
    BitRd br;
    while (unit < n_units) {
      if (chunk_idx >= chunks.size()) return kErrMalformed;
      br.reset(chunks[chunk_idx++]);
      int64_t preds[3] = {0, 0, 0};
      int64_t eobrun = 0;
      const int64_t stop = unit + interval < n_units ? unit + interval : n_units;
      while (unit < stop) {
        // gather this unit's blocks (one for ns==1; the MCU for ns>1,
        // at most 3 comps x 4x4 sampling = 48 blocks)
        int nblk = 0;
        int blk_ci[48];
        int32_t *bptr[48];
        if (ns == 1) {
          Component &c = comps[scan_comp[0]];
          const int64_t by = unit / cnbx, bx = unit % cnbx;
          blk_ci[0] = 0;
          bptr[0] = c.coef.data() + (by * c.nbx + bx) * 64;
          nblk = 1;
        } else {
          const int64_t my = unit / mcus_x, mx = unit % mcus_x;
          for (int s = 0; s < ns; ++s) {
            Component &c = comps[scan_comp[s]];
            for (int by = 0; by < c.v; ++by) {
              const int64_t row = (my * c.v + by) * c.nbx + mx * c.h;
              for (int bx = 0; bx < c.h; ++bx) {
                blk_ci[nblk] = s;
                bptr[nblk++] = c.coef.data() + (row + bx) * 64;
              }
            }
          }
        }
        for (int bi = 0; bi < nblk; ++bi) {
          const int ci = blk_ci[bi];
          int32_t *blk = bptr[bi];
          const Component &c = comps[scan_comp[ci]];
          if (dc_part) {
            if (refine) {
              if (br.bits(1)) blk[0] |= p1;
            } else {
              const int s = br.sym(hdc[c.td]);
              if (s < 0 || s > 15) return kErrMalformed;  // DC category 0..15
              int32_t diff = 0;
              if (s) diff = extend(static_cast<int>(br.bits(s)), s);
              // int32 wrap on the predictor AND after the point-transform
              // shift (fuzz safety; bus/jpeg.py::_wrap32 parity)
              preds[ci] = static_cast<int32_t>(
                  static_cast<uint32_t>(preds[ci] + diff));
              blk[0] = static_cast<int32_t>(
                  static_cast<uint32_t>(preds[ci]) << al);
            }
          }
          if (ac_part) {
            const Huff &act = hac[c.ta];
            const int rc = refine
                ? ac_refine_block(blk, act, band_lo, se, p1, m1, &eobrun, br)
                : ac_first_block(blk, act, band_lo, se, al, &eobrun, br);
            if (rc) return rc;
          }
        }
        ++unit;
      }
      if (br.bpos > br.nb + 4) return kErrMalformed;
    }
    return 0;
  }

  // Parse + decode every scan. The single-scan interleaved sequential
  // stream keeps its dedicated fast path.
  int decode_all() {
    int rc = parse_headers();
    if (rc) return rc;
    // fast path only when interleaved geometry applies: T.81 A.2.2 makes
    // every ns==1 scan non-interleaved, so a subsampled single-component
    // frame must go through decode_scan_multi's true block grid
    // (bus/jpeg.py dispatch parity)
    if (!progressive && scan_ns == ncomp &&
        (ncomp > 1 || (comps[0].h == 1 && comps[0].v == 1)))
      return decode_scan();
    alloc_coefs();
    int64_t pos = scan_pos;
    while (true) {
      int64_t end = 0;
      rc = decode_scan_multi(pos, &end);
      if (rc) return rc;
      rc = parse_from(end);
      if (rc == 0) {  // another SOS parsed
        pos = scan_pos;
        continue;
      }
      if (rc == 2) break;  // EOI or end of data — all scans in
      return rc;
    }
    for (int c = 0; c < ncomp; ++c)
      if (!qt_ok[comps[c].tq]) return kErrMalformed;
    return 0;
  }

  // Dequantize + de-zigzag + fixed-point islow IDCT one component into an
  // int32 sample plane (clipped 0..255), matching bus/jpeg.py::_idct_islow
  // BIT-FOR-BIT (integer math end to end — no FMA-contraction caveats).
  // libjpeg jidctint.c numerics: CONST_BITS=13, PASS1_BITS=2, constants
  // round(x*8192); worst-case error vs the exact real IDCT is <=1 count.
  // The plane is fully overwritten, so it is allocated UNinitialized
  // (profiled: zero-filling the three 8 MB planes cost ~40% as much as
  // the whole IDCT).
  //
  // One 1-D islow butterfly over all 8 LANES of a block at once (lane =
  // the non-transformed index, unit stride): straight-line int64
  // arithmetic the compiler vectorizes into one 8x64-bit vector per row
  // (AVX-512DQ vpmullq on this host; scalar elsewhere — identical values
  // either way). DESCALE by `shift` with round-half-up (arithmetic >>).
  static inline void islow_1d_lanes(const int64_t in[8][8],
                                    int64_t out[8][8], int shift) {
    const int64_t half = int64_t{1} << (shift - 1);
    for (int v = 0; v < 8; ++v) {
      // even part
      int64_t z1 = (in[2][v] + in[6][v]) * 4433;  // FIX_0_541196100
      const int64_t e2 = z1 - in[6][v] * 15137;   // -FIX_1_847759065
      const int64_t e3 = z1 + in[2][v] * 6270;    // FIX_0_765366865
      const int64_t e0 = (in[0][v] + in[4][v]) << 13;
      const int64_t e1 = (in[0][v] - in[4][v]) << 13;
      const int64_t t10 = e0 + e3, t13 = e0 - e3;
      const int64_t t11 = e1 + e2, t12 = e1 - e2;
      // odd part
      z1 = in[7][v] + in[1][v];
      int64_t z2 = in[5][v] + in[3][v];
      int64_t z3 = in[7][v] + in[3][v];
      int64_t z4 = in[5][v] + in[1][v];
      const int64_t z5 = (z3 + z4) * 9633;        // FIX_1_175875602
      int64_t t0 = in[7][v] * 2446;               // FIX_0_298631336
      int64_t t1 = in[5][v] * 16819;              // FIX_2_053119869
      int64_t t2 = in[3][v] * 25172;              // FIX_3_072711026
      int64_t t3 = in[1][v] * 12299;              // FIX_1_501321110
      z1 *= -7373;                                // -FIX_0_899976223
      z2 *= -20995;                               // -FIX_2_562915447
      z3 = z3 * -16069 + z5;                      // -FIX_1_961570560
      z4 = z4 * -3196 + z5;                       // -FIX_0_390180644
      t0 += z1 + z3;
      t1 += z2 + z4;
      t2 += z2 + z3;
      t3 += z1 + z4;
      out[0][v] = (t10 + t3 + half) >> shift;
      out[1][v] = (t11 + t2 + half) >> shift;
      out[2][v] = (t12 + t1 + half) >> shift;
      out[3][v] = (t13 + t0 + half) >> shift;
      out[4][v] = (t13 - t0 + half) >> shift;
      out[5][v] = (t12 - t1 + half) >> shift;
      out[6][v] = (t11 - t2 + half) >> shift;
      out[7][v] = (t10 - t3 + half) >> shift;
    }
  }

  void reconstruct(const Component &c, std::unique_ptr<int32_t[]> &plane_up) const {
    const int pw = c.nbx * 8;
    plane_up.reset(new int32_t[static_cast<size_t>(c.nby) * 8 * pw]);
    int32_t *plane = plane_up.get();
    const int32_t *q = qt[c.tq];
    int64_t B[8][8], M1[8][8], M2[8][8], OUT[8][8];
    for (int byy = 0; byy < c.nby; ++byy) {
      for (int bxx = 0; bxx < c.nbx; ++bxx) {
        const int32_t *blk =
            c.coef.data() + (static_cast<int64_t>(byy) * c.nbx + bxx) * 64;
        int nnz = 0;
        for (int u = 0; u < 8; ++u)
          for (int v = 0; v < 8; ++v) B[u][v] = 0;
        B[0][0] = static_cast<int64_t>(blk[0]) * q[0];
        for (int k = 1; k < 64; ++k) {
          if (!blk[k]) continue;
          const int idx = kZigzag[k];
          B[idx >> 3][idx & 7] = static_cast<int64_t>(blk[k]) * q[k];
          ++nnz;
        }
        if (nnz == 0) {
          // islow of a DC-only block is exactly (K + 4) >> 3 everywhere
          // (same shortcut as bus/jpeg.py::_reconstruct — bit-matched)
          int32_t p = static_cast<int32_t>((B[0][0] + 4) >> 3) + 128;
          p = p < 0 ? 0 : (p > 255 ? 255 : p);
          for (int x = 0; x < 8; ++x)
            for (int y = 0; y < 8; ++y)
              plane[(static_cast<int64_t>(byy) * 8 + x) * pw + bxx * 8 + y] = p;
          continue;
        }
        // pass 1 over columns (lane = v), transpose, pass 2 over rows
        // (lane = x), transpose back. All 8 lanes computed uncondition-
        // ally — the old zero-column shortcut contributed exactly 0, so
        // values are unchanged and the vector path wins on throughput.
        islow_1d_lanes(B, M1, 11);   // CONST_BITS - PASS1_BITS; M1[x][v]
        for (int a = 0; a < 8; ++a)
          for (int b = 0; b < 8; ++b) M2[a][b] = M1[b][a];  // M2[v][x]
        islow_1d_lanes(M2, OUT, 18);  // CONST_BITS+PASS1_BITS+3; OUT[y][x]
        for (int a = 0; a < 8; ++a)
          for (int b = 0; b < 8; ++b) M1[a][b] = OUT[b][a];  // M1[x][y]
        for (int x = 0; x < 8; ++x) {
          int32_t *dst =
              plane + (static_cast<int64_t>(byy) * 8 + x) * pw + bxx * 8;
          for (int y = 0; y < 8; ++y) {
            int32_t p = static_cast<int32_t>(M1[x][y]) + 128;
            dst[y] = p < 0 ? 0 : (p > 255 ? 255 : p);
          }
        }
      }
    }
  }

  // libjpeg h2v1 fancy horizontal 2x upsample (integer-exact, bus/jpeg.py).
  static void fancy_h2_row(const int32_t *in, int w, int32_t *out) {
    out[0] = in[0];
    out[2 * w - 1] = in[w - 1];
    for (int i = 1; i < w; ++i) out[2 * i] = (3 * in[i] + in[i - 1] + 1) >> 2;
    for (int i = 0; i < w - 1; ++i)
      out[2 * i + 1] = (3 * in[i] + in[i + 1] + 2) >> 2;
  }

  // Fill ONE upsampled output row of component c into out[width]
  // (integer-exact per-row forms of the libjpeg fancy upsamplers above;
  // row streaming avoids materializing three full-size planes — profiled
  // at ~half of emit()'s cost). scratch must hold >= 3*width + 8 ints.
  void upsample_row(const Component &c, const int32_t *plane, int hmax,
                    int vmax, int r, int32_t *out, int32_t *scratch) const {
    const int pw = c.nbx * 8;
    const int cw = (width * c.h + hmax - 1) / hmax;
    const int chh = (height * c.v + vmax - 1) / vmax;
    const int sh = (hmax % c.h == 0) ? hmax / c.h : 0;
    const int sv = (vmax % c.v == 0) ? vmax / c.v : 0;
    if (sh == 1 && sv == 1) {
      const int32_t *row = plane + static_cast<int64_t>(r) * pw;
      for (int col = 0; col < width; ++col) out[col] = row[col];
    } else if (sh == 2 && sv == 1) {
      int32_t *row = scratch;
      fancy_h2_row(plane + static_cast<int64_t>(r) * pw, cw, row);
      for (int col = 0; col < width; ++col) out[col] = row[col];
    } else if (sh == 1 && sv == 2) {  // transpose of fancy_h2, per column
      const int rr = r >> 1;
      const int other = (r & 1) ? (rr + 1 < chh ? rr + 1 : rr)
                                : (rr > 0 ? rr - 1 : rr);
      const bool edge = (r == 0) || (r == 2 * chh - 1);
      const int bias = (r & 1) ? 2 : 1;
      const int32_t *pa = plane + static_cast<int64_t>(rr) * pw;
      const int32_t *pb = plane + static_cast<int64_t>(other) * pw;
      for (int col = 0; col < width; ++col)
        out[col] = edge ? pa[col] : ((3 * pa[col] + pb[col] + bias) >> 2);
    } else if (sh == 2 && sv == 2) {
      // column sums (3*near + other row), then horizontal triangular pass
      int32_t *cs = scratch;
      int32_t *row = scratch + cw;
      const int rr = r >> 1;
      const int near = rr < chh ? rr : chh - 1;
      int other = (r & 1) ? near + 1 : near - 1;
      other = other < 0 ? 0 : (other >= chh ? chh - 1 : other);
      const int32_t *pn = plane + static_cast<int64_t>(near) * pw;
      const int32_t *po = plane + static_cast<int64_t>(other) * pw;
      for (int col = 0; col < cw; ++col) cs[col] = 3 * pn[col] + po[col];
      row[0] = (cs[0] * 4 + 8) >> 4;
      row[2 * cw - 1] = (cs[cw - 1] * 4 + 7) >> 4;
      for (int i = 1; i < cw; ++i) row[2 * i] = (3 * cs[i] + cs[i - 1] + 8) >> 4;
      for (int i = 0; i < cw - 1; ++i)
        row[2 * i + 1] = (3 * cs[i] + cs[i + 1] + 7) >> 4;
      for (int col = 0; col < width; ++col) out[col] = row[col];
    } else {  // non-dyadic: nearest neighbour
      const int ph = c.nby * 8;
      int yi = (r * c.v) / vmax;
      yi = yi >= ph ? ph - 1 : yi;
      const int32_t *row = plane + static_cast<int64_t>(yi) * pw;
      for (int col = 0; col < width; ++col) {
        int xi = (col * c.h) / hmax;
        xi = xi >= pw ? pw - 1 : xi;
        out[col] = row[xi];
      }
    }
  }

  int64_t emit(uint8_t *dst, int64_t cap) {
    const int64_t need = static_cast<int64_t>(height) * width * ncomp;
    if (cap < need) return kErrCapacity;
    int hmax = 1, vmax = 1;
    for (int c = 0; c < ncomp; ++c) {
      hmax = comps[c].h > hmax ? comps[c].h : hmax;
      vmax = comps[c].v > vmax ? comps[c].v : vmax;
    }
    if (ncomp == 1) {
      std::unique_ptr<int32_t[]> plane;
      reconstruct(comps[0], plane);
      const int pw = comps[0].nbx * 8;
      for (int r = 0; r < height; ++r)
        for (int col = 0; col < width; ++col)
          dst[static_cast<int64_t>(r) * width + col] = static_cast<uint8_t>(
              plane[static_cast<int64_t>(r) * pw + col]);
      return need;
    }
    std::unique_ptr<int32_t[]> planes[3];
    for (int c = 0; c < 3; ++c) reconstruct(comps[c], planes[c]);
    // row-streamed upsample + libjpeg 16.16 fixed-point YCbCr->RGB
    // (bus/jpeg.py parity) — no full-size intermediate planes
    std::vector<int32_t> yrow(width), cbrow(width), crrow(width),
        scratch(3 * static_cast<size_t>(width) + 8);
    for (int r = 0; r < height; ++r) {
      upsample_row(comps[0], planes[0].get(), hmax, vmax, r, yrow.data(),
                   scratch.data());
      upsample_row(comps[1], planes[1].get(), hmax, vmax, r, cbrow.data(),
                   scratch.data());
      upsample_row(comps[2], planes[2].get(), hmax, vmax, r, crrow.data(),
                   scratch.data());
      uint8_t *o = dst + static_cast<int64_t>(r) * width * 3;
      for (int col = 0; col < width; ++col) {
        const int32_t y = yrow[col];
        const int32_t cb = cbrow[col] - 128;
        const int32_t cr = crrow[col] - 128;
        int32_t rr = y + ((91881 * cr + 32768) >> 16);
        int32_t bb = y + ((116130 * cb + 32768) >> 16);
        int32_t gg = y + ((-22554 * cb - 46802 * cr + 32768) >> 16);
        rr = rr < 0 ? 0 : (rr > 255 ? 255 : rr);
        gg = gg < 0 ? 0 : (gg > 255 ? 255 : gg);
        bb = bb < 0 ? 0 : (bb > 255 ? 255 : bb);
        o[col * 3] = static_cast<uint8_t>(rr);
        o[col * 3 + 1] = static_cast<uint8_t>(gg);
        o[col * 3 + 2] = static_cast<uint8_t>(bb);
      }
    }
    return need;
  }
};

}  // namespace jpeg

extern "C" {

// Parse a JPEG header: fills h/w/ncomp. Returns 0, or -1 malformed /
// -2 unsupported (12-bit, CMYK, lossless, arithmetic ...).
int32_t jpeg_probe(const uint8_t *src, int64_t len, int32_t *h, int32_t *w,
                   int32_t *ncomp) {
  jpeg::Decoder d(src, len);
  const int rc = d.parse_headers();
  if (rc) return rc;
  *h = d.height;
  *w = d.width;
  *ncomp = d.ncomp;
  return 0;
}

// Decode a baseline or progressive JPEG into dst (interleaved RGB8 for
// 3-component, gray8 for 1-component). Returns bytes written, or
// -1 malformed / -2 unsupported / -3 dst too small.
int64_t jpeg_decode(const uint8_t *src, int64_t len, uint8_t *dst,
                    int64_t cap) {
  jpeg::Decoder d(src, len);
  const int rc = d.decode_all();
  if (rc) return rc;
  return d.emit(dst, cap);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Baseline JPEG encoder — native fast path for bus/jpeg.py::encode_jpeg
// (bag->bag transcode of decoded camera streams; the Python bit-writer
// costs seconds per 2MP frame). Same design as the Python encoder: 4:4:4,
// T.81 Annex K example quantization + Huffman tables, double-precision
// FDCT, trunc-half-away quantization. Output streams are spec-valid and
// decode within quantization error of the Python encoder's.

namespace jpegenc {

const int32_t kQLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int32_t kQChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// T.81 Annex K.3 table specs: 16 BITS counts + values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA};

struct EncTable {
  uint16_t code[256];
  uint8_t len[256];
  void build(const uint8_t *bits, const uint8_t *vals) {
    for (int i = 0; i < 256; ++i) len[i] = 0;
    uint32_t c = 0;
    int k = 0;
    for (int length = 1; length <= 16; ++length) {
      for (int i = 0; i < bits[length - 1]; ++i) {
        code[vals[k]] = static_cast<uint16_t>(c);
        len[vals[k]] = static_cast<uint8_t>(length);
        ++c;
        ++k;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  uint8_t *dst;
  int64_t cap, pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;
  void put(uint32_t code, int length) {
    acc = (acc << length) | (code & ((1ull << length) - 1));
    nbits += length;
    while (nbits >= 8) {
      const uint8_t b = static_cast<uint8_t>((acc >> (nbits - 8)) & 0xFF);
      emit(b);
      if (b == 0xFF) emit(0x00);  // byte stuffing
      nbits -= 8;
    }
    acc &= (1ull << nbits) - 1;
  }
  void flush() {
    if (nbits) {
      const int pad = 8 - nbits;
      put((1u << pad) - 1, pad);  // pad with 1-bits per spec
    }
  }
  void emit(uint8_t b) {
    if (pos >= cap) {
      overflow = true;
      return;
    }
    dst[pos++] = b;
  }
  void raw(const uint8_t *p, int64_t n) {
    for (int64_t i = 0; i < n; ++i) emit(p[i]);
  }
  void seg(uint8_t marker, const uint8_t *payload, int n) {
    emit(0xFF);
    emit(marker);
    emit(static_cast<uint8_t>((n + 2) >> 8));
    emit(static_cast<uint8_t>((n + 2) & 0xFF));
    raw(payload, n);
  }
};

inline int category(int v) {
  int a = v < 0 ? -v : v;
  int s = 0;
  while (a) {
    ++s;
    a >>= 1;
  }
  return s;
}

}  // namespace jpegenc

extern "C" {

// Encode uint8 gray (ncomp=1) or interleaved RGB (ncomp=3) as a baseline
// JPEG with the Annex K tables — 4:4:4, or 4:2:0 (sub420 != 0, RGB only;
// 2x2 integer box-averaged chroma, same samples as bus/jpeg.py's
// subsampling="420" path; streams agree with the Python encoder to the
// 4:4:4 contract — decode within +-1 count, double FDCT summation order
// is the only difference). Returns bytes written, or -1 bad args /
// -3 dst too small.
int64_t jpeg_encode_sub(const uint8_t *img, int32_t h, int32_t w,
                        int32_t ncomp, int32_t quality, int32_t sub420,
                        uint8_t *dst, int64_t cap) {
  using namespace jpegenc;
  if (h <= 0 || w <= 0 || (ncomp != 1 && ncomp != 3)) return -1;
  if (ncomp == 1) sub420 = 0;  // gray has no chroma to subsample
  quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  const int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  int32_t qluma[64], qchroma[64];
  for (int k = 0; k < 64; ++k) {
    int v = (kQLuma[k] * scale + 50) / 100;
    qluma[k] = v < 1 ? 1 : (v > 255 ? 255 : v);
    v = (kQChroma[k] * scale + 50) / 100;
    qchroma[k] = v < 1 ? 1 : (v > 255 ? 255 : v);
  }
  // IDCT basis (same constants as the decoder); FDCT is its transpose
  double A[8][8];
  for (int x = 0; x < 8; ++x)
    for (int u = 0; u < 8; ++u)
      A[x][u] = (u == 0 ? std::sqrt(0.5) : 1.0) / 2.0 *
                std::cos((2 * x + 1) * u * M_PI / 16.0);

  EncTable dc[2], ac[2];
  dc[0].build(kDcLumaBits, kDcVals);
  dc[1].build(kDcChromaBits, kDcVals);
  ac[0].build(kAcLumaBits, kAcLumaVals);
  ac[1].build(kAcChromaBits, kAcChromaVals);

  BitWriter bw{dst, cap};
  // SOI + JFIF APP0
  const uint8_t app0[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  bw.emit(0xFF);
  bw.emit(0xD8);
  bw.seg(0xE0, app0, sizeof(app0));
  // DQT (tables are raster here; the wire wants zigzag order)
  uint8_t dqt[65];
  dqt[0] = 0x00;
  for (int k = 0; k < 64; ++k) dqt[1 + k] = static_cast<uint8_t>(qluma[jpeg::kZigzag[k]]);
  bw.seg(0xDB, dqt, 65);
  if (ncomp == 3) {
    dqt[0] = 0x01;
    for (int k = 0; k < 64; ++k) dqt[1 + k] = static_cast<uint8_t>(qchroma[jpeg::kZigzag[k]]);
    bw.seg(0xDB, dqt, 65);
  }
  // SOF0
  uint8_t sof[2 + 4 + 1 + 9];
  int sn = 0;
  sof[sn++] = 8;
  sof[sn++] = static_cast<uint8_t>(h >> 8);
  sof[sn++] = static_cast<uint8_t>(h & 0xFF);
  sof[sn++] = static_cast<uint8_t>(w >> 8);
  sof[sn++] = static_cast<uint8_t>(w & 0xFF);
  sof[sn++] = static_cast<uint8_t>(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    sof[sn++] = static_cast<uint8_t>(c + 1);
    sof[sn++] = (sub420 && c == 0) ? 0x22 : 0x11;
    sof[sn++] = c == 0 ? 0 : 1;
  }
  bw.seg(0xC0, sof, sn);
  // DHT x4 (or x2 for gray)
  uint8_t dht[1 + 16 + 162];
  const struct {
    uint8_t id;
    const uint8_t *bits;
    const uint8_t *vals;
    int nvals;
  } tables[4] = {
      {0x00, kDcLumaBits, kDcVals, 12},
      {0x10, kAcLumaBits, kAcLumaVals, 162},
      {0x01, kDcChromaBits, kDcVals, 12},
      {0x11, kAcChromaBits, kAcChromaVals, 162},
  };
  const int ntab = ncomp == 3 ? 4 : 2;
  for (int t = 0; t < ntab; ++t) {
    dht[0] = tables[t].id;
    for (int k = 0; k < 16; ++k) dht[1 + k] = tables[t].bits[k];
    for (int k = 0; k < tables[t].nvals; ++k) dht[17 + k] = tables[t].vals[k];
    bw.seg(0xC4, dht, 17 + tables[t].nvals);
  }
  // SOS
  uint8_t sos[1 + 6 + 3];
  sn = 0;
  sos[sn++] = static_cast<uint8_t>(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    sos[sn++] = static_cast<uint8_t>(c + 1);
    sos[sn++] = c == 0 ? 0x00 : 0x11;
  }
  sos[sn++] = 0;
  sos[sn++] = 63;
  sos[sn++] = 0;
  bw.seg(0xDA, sos, sn);

  // entropy-coded scan
  int preds[3] = {0, 0, 0};
  double B[8][8], tmp[8][8];
  int32_t coef[64];
  // FDCT (F = A^T (blk - 128) A, double precision) + quantize +
  // huffman-emit one 8x8 block of component c
  auto encode_block = [&](const double blk[8][8], int c) {
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) B[y][x] = blk[y][x] - 128.0;
    for (int u = 0; u < 8; ++u)
      for (int y = 0; y < 8; ++y) {
        double s = 0.0;
        for (int x = 0; x < 8; ++x) s += A[x][u] * B[x][y];
        tmp[u][y] = s;
      }
    const int32_t *q = c == 0 ? qluma : qchroma;
    for (int u = 0; u < 8; ++u)
      for (int v = 0; v < 8; ++v) {
        double s = 0.0;
        for (int y = 0; y < 8; ++y) s += tmp[u][y] * A[y][v];
        const int idx = u * 8 + v;
        const double scaled = s / q[idx];
        coef[idx] = static_cast<int32_t>(
            scaled >= 0 ? std::floor(scaled + 0.5) : std::ceil(scaled - 0.5));
      }
    const EncTable &dct = dc[c == 0 ? 0 : 1];
    const EncTable &act = ac[c == 0 ? 0 : 1];
    const int dcv = coef[0];
    int diff = dcv - preds[c];
    preds[c] = dcv;
    int s = category(diff);
    bw.put(dct.code[s], dct.len[s]);
    if (s) bw.put(diff >= 0 ? diff : diff + (1 << s) - 1, s);
    int run = 0, last_nz = 0;
    for (int k = 63; k >= 1; --k) {
      if (coef[jpeg::kZigzag[k]]) {
        last_nz = k;
        break;
      }
    }
    for (int k = 1; k <= last_nz; ++k) {
      const int v = coef[jpeg::kZigzag[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(act.code[0xF0], act.len[0xF0]);
        run -= 16;
      }
      s = category(v);
      bw.put(act.code[(run << 4) | s], act.len[(run << 4) | s]);
      bw.put(v >= 0 ? v : v + (1 << s) - 1, s);
      run = 0;
    }
    if (last_nz < 63) bw.put(act.code[0x00], act.len[0x00]);
  };
  // rounded + clamped YCbCr of source pixel (sy, sx), edge-replicated
  auto load_ycc = [&](int sy, int sx, double out[3]) {
    sy = sy >= h ? h - 1 : sy;
    sx = sx >= w ? w - 1 : sx;
    if (ncomp == 1) {
      out[0] = img[static_cast<int64_t>(sy) * w + sx];
      return;
    }
    const uint8_t *p = img + (static_cast<int64_t>(sy) * w + sx) * 3;
    const double r = p[0], g = p[1], b = p[2];
    double yv = std::floor(0.299 * r + 0.587 * g + 0.114 * b + 0.5);
    double cb = std::floor(-0.168736 * r - 0.331264 * g + 0.5 * b + 128.0 + 0.5);
    double cr = std::floor(0.5 * r - 0.418688 * g - 0.081312 * b + 128.0 + 0.5);
    out[0] = yv < 0 ? 0 : (yv > 255 ? 255 : yv);
    out[1] = cb < 0 ? 0 : (cb > 255 ? 255 : cb);
    out[2] = cr < 0 ? 0 : (cr > 255 ? 255 : cr);
  };

  if (sub420) {
    // MCU = 16x16 luma (2x2 blocks, row-major) + one 8x8 Cb + Cr from a
    // 2x2 integer box average (bias +2) of the rounded chroma samples —
    // the same samples bus/jpeg.py feeds its FDCT (pad-then-average ==
    // clamp-then-average under edge replication)
    const int mx = (w + 15) / 16, my = (h + 15) / 16;
    double y16[16][16];
    int cb16[16][16], cr16[16][16];
    double blk8[8][8], cbb[8][8], crb[8][8];
    for (int m = 0; m < mx * my; ++m) {
      const int mr = m / mx, mc = m % mx;
      for (int yy = 0; yy < 16; ++yy)
        for (int xx = 0; xx < 16; ++xx) {
          double ycc[3] = {0.0, 0.0, 0.0};  // gray never reaches sub420
          load_ycc(mr * 16 + yy, mc * 16 + xx, ycc);
          y16[yy][xx] = ycc[0];
          cb16[yy][xx] = static_cast<int>(ycc[1]);
          cr16[yy][xx] = static_cast<int>(ycc[2]);
        }
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          for (int y = 0; y < 8; ++y)
            for (int x = 0; x < 8; ++x)
              blk8[y][x] = y16[by * 8 + y][bx * 8 + x];
          encode_block(blk8, 0);
        }
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) {
          cbb[y][x] = (cb16[2 * y][2 * x] + cb16[2 * y][2 * x + 1] +
                       cb16[2 * y + 1][2 * x] + cb16[2 * y + 1][2 * x + 1] + 2) >> 2;
          crb[y][x] = (cr16[2 * y][2 * x] + cr16[2 * y][2 * x + 1] +
                       cr16[2 * y + 1][2 * x] + cr16[2 * y + 1][2 * x + 1] + 2) >> 2;
        }
      encode_block(cbb, 1);
      encode_block(crb, 2);
    }
  } else {
    // 4:4:4 (or gray): per 8x8 MCU, all components
    const int bh = (h + 7) / 8, bwid = (w + 7) / 8;
    double plane[3][8][8];
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bwid; ++bx) {
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) {
            double ycc[3];
            load_ycc(by * 8 + y, bx * 8 + x, ycc);
            for (int c = 0; c < ncomp; ++c) plane[c][y][x] = ycc[c];
          }
        for (int c = 0; c < ncomp; ++c) encode_block(plane[c], c);
      }
  }
  bw.flush();
  bw.emit(0xFF);
  bw.emit(0xD9);
  if (bw.overflow) return -3;
  return bw.pos;
}

// backward-compatible 4:4:4 entry point
int64_t jpeg_encode(const uint8_t *img, int32_t h, int32_t w, int32_t ncomp,
                    int32_t quality, uint8_t *dst, int64_t cap) {
  return jpeg_encode_sub(img, h, w, ncomp, quality, 0, dst, cap);
}

}  // extern "C"
