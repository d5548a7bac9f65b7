// Tile splat renderer kernels for Hopper (sm_90a): K6 and K7. Plain C
// interface, built into one library with fused_vis.cu and loaded with ctypes
// by trajectory_optimization_tpu_torch/ops/_kernels.py; each entry point
// launches on the caller's stream and returns cudaGetLastError().
//
//   sr_splat_runs  (K6) replaces _splat_runs_kernel,
//                  trajectory_optimization_tpu/ops/pallas_render.py:105
//   sr_splat_dense (K7) replaces _splat_kernel, pallas_render.py:134
//
// Plain PyTorch versions with the same inputs and outputs are splat_runs_ref
// and splat_dense_ref in trajectory_optimization_tpu_torch/ops/tile_render.py,
// which also builds the inputs (the prologue) and models this kernel's cull
// (band_cull).
//
// Inputs: offsets (n_tiles + 1,) i32 into entries (M, 8) f32, rows
// [round(u), round(v), z, r^2, r, g, b, 0] sorted stably by bin. K6 bins
// each point once (the tile holding its footprint's top-left corner), so
// tile (ty, tx) scans the run of bins (ty-1, max(tx-1,0)..tx) when ty >= 1,
// then (ty, max(tx-1,0)..tx). K7's entries are duplicated per touched tile
// and tile t scans [offsets[t], offsets[t] + min(count_t, max_e)): the
// entries the JAX twin packs into its (n_tiles, MAX_E, 8) block, read in
// place. Output: planar R, G, B, (3, Hp, Wp) f32; the wrapper crops.
//
// The blend rule is the JAX twin's (_blend_body, pallas_render.py:76-92):
// a pixel is covered iff dr*dr + dc*dc <= r^2; an entry takes it iff
// z < zbuf, strictly, starting from z = 3.0e38 and the background, so among
// equal depths the first entry in scan order wins.
//
// Design: one block of 8 warps per 32x128 tile. Warp w owns the band of
// columns [16w, 16w + 16) of the tile, all 32 rows, and nothing else: the
// tile's z-buffer and the index of each pixel's winning entry live in
// shared memory (8 bytes a pixel; colours are gathered once, at the end),
// and no two warps touch one pixel, so the warps never wait for each other.
// (Bands of 16 columns ran faster than bands of 32 or 8 on K7 at 8m and K6
// at cloud 10: more warps in flight, at the cost of more entries that reach
// two bands.)
// - Cull once per warp, 32 entries at a time. Each lane loads one entry of
//   the scan range and tests its footprint against the band: the distance
//   from (u, v) to the band's pixel box, (dr0, dc0), must satisfy
//   dr0^2 + dc0^2 <= r^2. u and v are integer-valued, so the box's nearest
//   pixel is at exactly that distance: the test keeps an entry iff it covers
//   a pixel of the band, and dropping the others is exact. A ballot gives
//   the survivors in scan order; the warp blends them one after the other
//   (lowest lane first), so equal depths keep the first in scan order. An
//   entry reaches 1-2 of the 8 bands; K6's entries of the four scanned bins
//   that miss the tile reach none.
// - Blend only the footprint. The survivor's box, its 2S+1 rows and columns
//   around (v, u) with S = floor(sqrtf(r^2)), clipped to the band, is spread
//   over the 32 lanes, one pixel per lane (81 pixels, 3 rounds, at r = 4).
//   A pixel outside the box has |dr| or |dc| > S >= floor(sqrt(r^2)) (sqrtf
//   is correctly rounded and monotone, so it never falls below an integer
//   that the true root reaches), and dr and dc are integers, so it is not
//   covered: skipping it is exact. Within one entry each pixel goes to one
//   lane; __syncwarp orders consecutive entries.
// - dr and dc are integer-valued, so dr*dr + dc*dc is exact with or without
//   FMA contraction while it is below 2^24 (and far above r^2 beyond that):
//   the coverage test is exact and the images equal the plain version's bit
//   for bit. No atomics.
// The shared row stride is 128 + 9 floats: pixel (y, x) falls in bank
// (9y + x) mod 32, so the 32 pixels of a 9-wide box row-major round hit 32
// distinct banks.
//
// Bound on this card: at the reference camera (1616x1232, 510 tiles,
// Hp x Wp = 1632 x 1280) the image write alone is 3 x 1632 x 1280 x 4 B =
// 25.1 MB, ~7.5 us at 3.35 TB/s, against a few bytes per entry read and a
// handful of operations per covered pixel: bytes bound it. The time goes to
// issuing instructions: ~25 per lane round of the cull, ~20 per round of a
// survivor's box.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kBandW = 16;                // columns per warp
constexpr int kWarps = kTileW / kBandW;   // warps per tile
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = kTileW + 9;       // shared floats per tile row (bank spread)
constexpr float kFar = 3.0e38f;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kBandW <= 32 && 32 % kBandW == 0, "a band is at most one lane per column");
static_assert(kTileH <= 32, "box offsets and sizes are packed in 5 bits");

struct Run {
  int lo;
  int n;
};

// Blend the entries of runs a then b (scan order) into tile (ty, tx).
__device__ __forceinline__ void blend_tile(const float4* __restrict__ entries, Run a, Run b,
                                           int ty, int tx, float bg, float* __restrict__ out,
                                           long long plane, int Wp) {
  __shared__ float s_z[kTileH * kStride];
  __shared__ int s_win[kTileH * kStride];  // winning entry's row in entries, -1: background
  const int lane = threadIdx.x & 31;
  const int band = threadIdx.x >> 5;
  const int bx = band * kBandW;                       // band's first column in the tile
  constexpr int kRowStep = 32 / kBandW;               // rows between a lane's pixels
  const int my_x = bx + lane % kBandW, my_y0 = lane / kBandW;
  for (int y = my_y0; y < kTileH; y += kRowStep) {
    s_z[y * kStride + my_x] = kFar;
    s_win[y * kStride + my_x] = -1;
  }
  __syncwarp();

  // the band's pixel box, in image coordinates (small integers: exact)
  const float x0 = static_cast<float>(tx * kTileW + bx), x1 = x0 + (kBandW - 1);
  const float y0 = static_cast<float>(ty * kTileH), y1 = y0 + (kTileH - 1);
  const int total = a.n + b.n;
  // lane's entry of the round starting at base: (row in entries, u v z r^2);
  // r^2 < 0 past the end covers nothing
  auto fetch = [&](int base, int& e, float4& g) {
    const int k = base + lane;
    e = k < a.n ? a.lo + k : b.lo + (k - a.n);
    g = k < total ? __ldg(entries + 2 * static_cast<long long>(e))
                  : make_float4(0.f, 0.f, 0.f, -1.f);
  };
  int e_next;
  float4 g_next;
  fetch(0, e_next, g_next);
  for (int base = 0; base < total; base += 32) {
    const int e = e_next;
    const float4 g = g_next;
    if (base + 32 < total) fetch(base + 32, e_next, g_next);  // in flight during the blend
    const float dc0 = fmaxf(fmaxf(x0 - g.x, 0.f), g.x - x1);
    const float dr0 = fmaxf(fmaxf(y0 - g.y, 0.f), g.y - y1);
    const float s = floorf(sqrtf(g.w));
    const int c_lo = static_cast<int>(fmaxf(g.x - s, x0) - x0);
    const int c_hi = static_cast<int>(fminf(g.x + s, x1) - x0);
    const int r_lo = static_cast<int>(fmaxf(g.y - s, y0) - y0);
    const int r_hi = static_cast<int>(fminf(g.y + s, y1) - y0);
    const bool keep = dr0 * dr0 + dc0 * dc0 <= g.w && c_hi >= c_lo && r_hi >= r_lo;
    const int bw = c_hi - c_lo + 1;
    const int box = c_lo | (r_lo << 5) | ((bw - 1) << 10) | ((r_hi - r_lo) << 15);
    const float inv_bw = 1.0f / static_cast<float>(max(bw, 1));
    unsigned m = __ballot_sync(kAll, keep);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float u = __shfl_sync(kAll, g.x, src), v = __shfl_sync(kAll, g.y, src);
      const float z = __shfl_sync(kAll, g.z, src), r2 = __shfl_sync(kAll, g.w, src);
      const int win = __shfl_sync(kAll, e, src), bx_s = __shfl_sync(kAll, box, src);
      const float inv = __shfl_sync(kAll, inv_bw, src);
      const int cl = bx_s & 31, rl = (bx_s >> 5) & 31;
      const int w = ((bx_s >> 10) & 31) + 1, n = w * (((bx_s >> 15) & 31) + 1);
      for (int q = lane; q < n; q += 32) {
        // q = dy * w + dx; (q + 0.5) / w is at least 0.5 / w from an
        // integer, far above the product's rounding error at q < 1024
        const int dy = static_cast<int>((static_cast<float>(q) + 0.5f) * inv);
        const int dx = q - dy * w;
        const float dr = (y0 + static_cast<float>(rl + dy)) - v;
        const float dc = (x0 + static_cast<float>(cl + dx)) - u;
        if (dr * dr + dc * dc <= r2) {
          const int p = (rl + dy) * kStride + bx + cl + dx;
          if (z < s_z[p]) {
            s_z[p] = z;
            s_win[p] = win;
          }
        }
      }
      __syncwarp();
    }
  }

  const long long col = static_cast<long long>(tx) * kTileW + my_x;
#pragma unroll 4
  for (int y = my_y0; y < kTileH; y += kRowStep) {
    const int win = s_win[y * kStride + my_x];
    float cr = bg, cg = bg, cb = bg;
    if (win >= 0) {
      const float4 c = __ldg(entries + 2 * static_cast<long long>(win) + 1);
      cr = c.x;
      cg = c.y;
      cb = c.z;
    }
    const long long p = static_cast<long long>(ty * kTileH + y) * Wp + col;
    out[p] = cr;
    out[plane + p] = cg;
    out[2 * plane + p] = cb;
  }
}

__global__ void __launch_bounds__(kThreads)
splat_runs_kernel(const int* __restrict__ offsets, const float4* __restrict__ entries,
                  int tiles_x, float bg, float* __restrict__ out, long long plane, int Wp) {
  const int t = blockIdx.x;
  const int ty = t / tiles_x, tx = t % tiles_x;
  const int c_lo = max(tx - 1, 0);
  Run r[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int row = ty - 1 + d;
    if (row >= 0) {
      const int lo = offsets[row * tiles_x + c_lo];
      r[d] = Run{lo, offsets[row * tiles_x + tx + 1] - lo};
    } else {
      r[d] = Run{0, 0};
    }
  }
  blend_tile(entries, r[0], r[1], ty, tx, bg, out, plane, Wp);
}

__global__ void __launch_bounds__(kThreads)
splat_dense_kernel(const int* __restrict__ offsets, const float4* __restrict__ entries,
                   int max_e, int tiles_x, float bg, float* __restrict__ out, long long plane,
                   int Wp) {
  const int t = blockIdx.x;
  const int lo = offsets[t];
  const Run r{lo, min(offsets[t + 1] - lo, max_e)};
  blend_tile(entries, r, Run{0, 0}, t / tiles_x, t % tiles_x, bg, out, plane, Wp);
}

}  // namespace

extern "C" {

int sr_tile_h() { return kTileH; }
int sr_tile_w() { return kTileW; }
int sr_band_w() { return kBandW; }

// Blocks of K6 (dense = 0) or K7 (dense = 1) that one SM holds at once, as
// the runtime computes it from the kernel's registers and shared memory;
// a negated CUDA error code on failure.
int sr_resident_blocks(int dense) {
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, dense ? reinterpret_cast<const void*>(splat_dense_kernel)
                : reinterpret_cast<const void*>(splat_runs_kernel),
      kThreads, 0);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

int sr_splat_runs(const int* offsets, const float* entries, int tiles_y, int tiles_x,
                  float bg, float* out, void* stream) {
  const int Wp = tiles_x * kTileW;
  const long long plane = static_cast<long long>(tiles_y) * kTileH * Wp;
  splat_runs_kernel<<<tiles_y * tiles_x, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      offsets, reinterpret_cast<const float4*>(entries), tiles_x, bg, out, plane, Wp);
  return static_cast<int>(cudaGetLastError());
}

int sr_splat_dense(const int* offsets, const float* entries, int max_e, int tiles_y,
                   int tiles_x, float bg, float* out, void* stream) {
  const int Wp = tiles_x * kTileW;
  const long long plane = static_cast<long long>(tiles_y) * kTileH * Wp;
  splat_dense_kernel<<<tiles_y * tiles_x, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      offsets, reinterpret_cast<const float4*>(entries), max_e, tiles_x, bg, out, plane, Wp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
