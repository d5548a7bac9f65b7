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
// which also builds the inputs (the prologue).
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
// Design: one block of 256 threads per 32x128 tile. Thread t owns column
// t % 128 and the 16 rows t / 128 + 2k, keeping their depth and colour in
// registers (64 floats); each output pixel is written once, with neighbouring
// threads on neighbouring addresses. The scan range goes through shared
// memory 256 entries (8 KB) at a time, and every thread tests every staged
// entry against its pixels in scan order with the JAX blend rule
// (_blend_body, pallas_render.py:76-92): covered iff dr*dr + dc*dc <= r^2,
// taken iff z < zbuf (strict), starting from z = 3.0e38 and the background.
// dr and dc are integer-valued, so dr*dr + dc*dc is exact with or without
// FMA contraction while it is below 2^24 (and far above r^2 <= 16 beyond
// that): the coverage test is exact and the images equal the plain
// version's bit for bit. A thread skips an entry at once when
// dc*dc > r^2 (then no dr can cover); that skip is exact too. No atomics.
//
// Bound on this card: at the reference camera (1616x1232, 510 tiles,
// Hp x Wp = 1632 x 1280) the image write alone is 3 x 1632 x 1280 x 4 B =
// 25.1 MB, ~7.5 us at 3.35 TB/s, against a few bytes per entry read and a
// handful of operations per covered pixel: bytes bound it. This brute-force
// scan does more work than the covered pixels need (every thread looks at
// every entry of its tile's scan range, ~4 bins' worth for K6); making it
// fast is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTileW;  // rows between a thread's pixels
constexpr int kPix = kTileH / kRowStep;      // pixels per thread
constexpr int kChunk = kThreads;             // entries staged per round
constexpr float kFar = 3.0e38f;

struct Run {
  long long lo;
  int n;
};

// Blend the entries of runs a then b (scan order) into tile (ty, tx).
__device__ __forceinline__ void blend_tile(const float4* __restrict__ entries, Run a, Run b,
                                           int ty, int tx, float bg, float* __restrict__ out,
                                           long long plane, int Wp) {
  __shared__ float4 s_geo[kChunk];  // u, v, z, r^2
  __shared__ float4 s_rgb[kChunk];  // r, g, b, 0
  const int col = threadIdx.x % kTileW;
  const int row0 = threadIdx.x / kTileW;
  const float fcol = static_cast<float>(tx * kTileW + col);
  const int y0 = ty * kTileH + row0;
  float zb[kPix], cr[kPix], cg[kPix], cb[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    zb[i] = kFar;
    cr[i] = bg;
    cg[i] = bg;
    cb[i] = bg;
  }
  const int total = a.n + b.n;
  for (int base = 0; base < total; base += kChunk) {
    const int k = base + static_cast<int>(threadIdx.x);
    if (k < total) {
      const long long e = k < a.n ? a.lo + k : b.lo + (k - a.n);
      s_geo[threadIdx.x] = entries[2 * e];
      s_rgb[threadIdx.x] = entries[2 * e + 1];
    }
    __syncthreads();
    const int m = min(kChunk, total - base);
    for (int j = 0; j < m; ++j) {
      const float4 g = s_geo[j];
      const float dc = fcol - g.x;
      const float dc2 = dc * dc;
      if (dc2 > g.w) continue;
      const float4 c = s_rgb[j];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const float dr = static_cast<float>(y0 + kRowStep * i) - g.y;
        if (dr * dr + dc2 <= g.w && g.z < zb[i]) {
          zb[i] = g.z;
          cr[i] = c.x;
          cg[i] = c.y;
          cb[i] = c.z;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const long long p = static_cast<long long>(y0 + kRowStep * i) * Wp + tx * kTileW + col;
    out[p] = cr[i];
    out[plane + p] = cg[i];
    out[2 * plane + p] = cb[i];
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
