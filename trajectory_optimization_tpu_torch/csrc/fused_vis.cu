// Fused visibility log-odds kernels for Hopper (sm_90a): K1-K4 of the
// score-cache regime and K1', K2', K5 of the uncached regime (no (W, N)
// buffer). Plain C interface, loaded with ctypes by
// trajectory_optimization_tpu_torch/ops/_kernels.py; each entry point
// launches on the caller's stream and returns cudaGetLastError().
//
// Plain PyTorch versions of every kernel, with the same inputs and outputs,
// live in trajectory_optimization_tpu_torch/ops/fused_vis.py (*_ref).
//
// Layout (no TPU tiling): points are a contiguous SoA (3, N) f32; valid and
// the cotangent g are (N,) f32; the score cache is (W, N) f32, row w
// contiguous; wp is (W, 12) = [R row-major 9, t 3]; kp is [fx, fy, cx, cy];
// norm is (W, 4) = [m, inv_d, gate, M]; norm2 (W, 6) adds alpha and beta.
// The ragged edge i >= N is masked in the kernel.
//
// Grid for K3, K4, K5: blockIdx.x over blocks of kBlockPts points (kPPT per
// thread, neighbouring threads on neighbouring points), blockIdx.y over
// chunks of kWChunk waypoints, a loop over the chunk's waypoints inside the
// block. Per-block results go to (n_blocks, W[, slots]) partials that the
// wrapper reduces with torch.sum: no float atomics, so a run is reproducible
// bit for bit. K2 is one thread per point and K2' one thread per kPPT points,
// looping over all W in order. Pass A (K1, K1') is a persistent grid sized to
// the card: each block walks over point tiles, reads a tile's points once,
// evaluates every waypoint against them and keeps running minima and maxima
// that it merges into the final (W,) outputs with integer atomicMin/atomicMax
// (order-free, so exact and reproducible); see pass_a_kernel.
//
// Built WITHOUT --use_fast_math / -ftz: far points give denormal scores, and
// the min-tie count (s == m) depends on denormals surviving as they do in
// the plain version. expf, logf and '/' are the IEEE-accurate versions.
//
// The score s = sig * exp(arg) is computed with explicitly rounded adds and
// multiplies (__fadd_rn etc., which the compiler never contracts into FMAs),
// so every kernel that computes it gets the same bits: in the uncached
// regime K5 tests s == m on its own recompute against the min K1' took over
// its own. The operations and their order are those of the plain version,
// whose PyTorch ops each round once, so on the card the two agree bit for
// bit as well. The gradient chain after the score keeps FMA contraction.
//
// The cached K2, K3 and K4 are bound by device-memory bandwidth, not
// arithmetic: at 1M points x 50 waypoints each reads the 200 MB cache that K1
// wrote, against ~40 flops and at most 2 exp per (w, i). The design answers
// that only by touching each cache element once per kernel with coalesced
// accesses and keeping the point coordinates of a block in registers across
// its waypoint chunk. K2' and K5 read 16-20 B per point (and waypoint chunk)
// and are bound by the recompute arithmetic instead. They compute only what
// can be nonzero: outside the strict clip window (0.5, 1 - eps) a pair's log
// term and direct gradient terms are exactly zero, as is a min or max tie's
// term when its score is 0, and on a large map that is nearly every pair.
// Pass A is bound by the score's arithmetic too (K1 also by its cache write)
// and needs only min and max, so it finishes a pair after the score's first
// 27 operations wherever those already decide that the pair changes neither
// (tile_prefix, pass_a_kernel).

#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPPT = 4;                       // points per thread
constexpr int kBlockPts = kThreads * kPPT;    // points per block
constexpr int kWChunk = 8;                    // waypoints per block (K3/K4/K5)
constexpr int kStageW = 128;                  // waypoints staged in shared memory (pass A, K2')
constexpr int kBwdSlots = 40;                 // K5's sums per waypoint
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kBig = 3.0e38f;

// Pass A's pruning constants (ops/_kernels.py holds the same values for the
// plain predicate fused_vis.prune_masks and checks them when it loads this
// library). With T0 = d2 * inv_var, the first term of the exponent:
//   T0 >= kZeroT  =>  arg <= -kZeroT / 2 = -105  =>  expf(arg) == +0, so the
//     score is +0. e^-105 is 0.18 of the smallest denormal; that this expf
//     returns +0 for every float x <= -105 is proved on the card by
//     expf_zero_kernel below.
//   T0 > -2 logf(M) + kMaxMargin, M >= kMaxFloor a score already seen  =>
//     score < M. The margin is ~250 times what the roundings need: logf is
//     within 1 ulp of a value below 70 and the add rounds once (together under
//     5e-5 in T0), expf is within 2 ulp of e^arg (a factor 1 + 2.4e-7, and at
//     most 2.8e-45 absolute where the result is denormal, far under
//     kMaxFloor), and nothing here needs expf to be monotone.
constexpr float kZeroT = 210.0f;
constexpr float kMaxMargin = 0.015625f;
constexpr float kMaxFloor = 1.0e-30f;
// A NaN score of a valid point makes its waypoint's min and max NaN, as the
// plain version's amin/amax do. As signed integers these two NaNs lie below
// and above the bits of every score (scores are >= +0), so the integer
// min/max that carry the running values keep them.
constexpr int kNanMinBits = static_cast<int>(0xffc00000u);
constexpr int kNanMaxBits = 0x7fc00000;
constexpr int kMaxDevices = 64;

struct Consts {
  float c0, inv_var, img_w, img_h, eps, inv_w, inv_h;
};

struct Cam {
  float fx, fy, cx0, cy0;
};

// Transform/projection intermediates for one (waypoint, point): everything
// of the score except the final exp (pallas_vis.py _tile_extras).
struct Extras {
  float ex, ey, ez, u, v, inv_zd, xu, xv, xu_raw, xv_raw, sig, arg;
};

// Rounded arithmetic that is never contracted into an FMA (see the header).
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// The score's first 27 operations: the camera-frame point, its offset from
// the sweet spot (c0, c0, c0) and t0 = d2 * inv_var, the exponent's distance
// term. Every later term of the exponent is a square, and a rounded add of a
// non-negative term never lowers a sum, so arg <= -t0 / 2 exactly; with
// 0 <= sig <= 1 that gives score <= expf(arg) with arg <= -t0 / 2, the bound
// pass A prunes with.
struct Prefix {
  float cx, cy, cz, ex, ey, ez, t0;
};

// Same order of operations as the plain version (fused_vis.py _extras);
// tile_rest continues from tile_prefix's values, so the two in a row are the
// whole score whoever calls them.
__device__ __forceinline__ Prefix tile_prefix(float px, float py, float pz,
                                              const float* __restrict__ w, const Consts& k) {
  Prefix p;
  const float dx = sub(px, w[9]), dy = sub(py, w[10]), dz = sub(pz, w[11]);
  p.cx = add(add(mul(dx, w[0]), mul(dy, w[3])), mul(dz, w[6]));
  p.cy = add(add(mul(dx, w[1]), mul(dy, w[4])), mul(dz, w[7]));
  p.cz = add(add(mul(dx, w[2]), mul(dy, w[5])), mul(dz, w[8]));
  p.ex = sub(p.cx, k.c0);
  p.ey = sub(p.cy, k.c0);
  p.ez = sub(p.cz, k.c0);
  const float d2 = add(add(mul(p.ex, p.ex), mul(p.ey, p.ey)), mul(p.ez, p.ez));
  p.t0 = mul(d2, k.inv_var);
  return p;
}

__device__ __forceinline__ Extras tile_rest(const Prefix& p, const Cam& cam, const Consts& k) {
  Extras e;
  e.ex = p.ex;
  e.ey = p.ey;
  e.ez = p.ez;
  e.u = add(mul(cam.fx, p.cx), mul(cam.cx0, p.cz));
  e.v = add(mul(cam.fy, p.cy), mul(cam.cy0, p.cz));
  float zd = add(p.cz, k.eps);
  zd = zd >= 0.0f ? fmaxf(zd, 1e-12f) : fminf(zd, -1e-12f);
  e.inv_zd = 1.0f / zd;
  e.xu_raw = mul(sub(mul(e.u, e.inv_zd), mul(k.img_w, 0.5f)), k.inv_w);
  e.xv_raw = mul(sub(mul(e.v, e.inv_zd), mul(k.img_h, 0.5f)), k.inv_h);
  e.xu = fminf(fmaxf(e.xu_raw, -20.0f), 20.0f);
  e.xv = fminf(fmaxf(e.xv_raw, -20.0f), 20.0f);
  e.sig = 1.0f / add(1.0f, expf(-p.cz));
  e.arg = mul(-0.5f, add(add(p.t0, mul(e.xu, e.xu)), mul(e.xv, e.xv)));
  return e;
}

__device__ __forceinline__ Extras tile_extras(float px, float py, float pz,
                                              const float* __restrict__ w,
                                              const Cam& cam, const Consts& k) {
  return tile_rest(tile_prefix(px, py, pz, w, k), cam, k);
}

__device__ __forceinline__ float score(const Extras& e) { return mul(e.sig, expf(e.arg)); }

// The camera-frame factors of pallas_vis.py _tile_dcam: for a score
// cotangent c, (dcx, dcy, dcz) = (c * s) * (bx, by, bz).
struct DcamFactors {
  float bx, by, bz;
};

__device__ __forceinline__ DcamFactors dcam_factors(const Extras& e, const Cam& cam,
                                                    const Consts& k) {
  const float g_u = fabsf(e.xu_raw) < 20.0f ? 1.0f : 0.0f;
  const float g_v = fabsf(e.xv_raw) < 20.0f ? 1.0f : 0.0f;
  DcamFactors f;
  f.bx = -(e.ex * k.inv_var) - e.xu * g_u * (cam.fx * e.inv_zd * k.inv_w);
  f.by = -(e.ey * k.inv_var) - e.xv * g_v * (cam.fy * e.inv_zd * k.inv_h);
  f.bz = -(e.ez * k.inv_var) + (1.0f - e.sig) -
         e.xu * g_u * (cam.cx0 * e.inv_zd - e.u * e.inv_zd * e.inv_zd) * k.inv_w -
         e.xv * g_v * (cam.cy0 * e.inv_zd - e.v * e.inv_zd * e.inv_zd) * k.inv_h;
  return f;
}

__device__ __forceinline__ float clip_pn(float x, float hi) {
  return fminf(fmaxf(x, 0.5f), hi);
}

// log-odds cotangent inside the strict clip window, 0 outside it.
__device__ __forceinline__ float pn_cotangent(float pn_raw, float g, float hi) {
  const bool active = pn_raw > 0.5f && pn_raw < hi;
  const float pn = clip_pn(pn_raw, hi);
  return active ? g / (pn * (1.0f - pn)) : 0.0f;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The skip threshold of K1' for one waypoint from its running min and max (as
// integer bits): +inf until the min is +0 (a skipped pair is also left out of
// the min, and only a min of +0 can no longer fall: scores are >= +0); then
// pairs with t0 above it are skipped, the exact zeros (t0 >= kZeroT) among
// them, and those under the running max where that is large enough to bound.
__device__ __forceinline__ float skip_threshold(int min_bits, int max_bits) {
  if (min_bits != 0) return __int_as_float(0x7f800000);
  const float zero_thr = __int_as_float(__float_as_int(kZeroT) - 1);  // t0 > this == t0 >= kZeroT
  const float mx = __int_as_float(max_bits);
  return mx >= kMaxFloor ? fminf(add(mul(-2.0f, logf(mx)), kMaxMargin), zero_thr) : zero_thr;
}

// Merge the block's running min/max of one waypoint into the grid's, take the
// grid's back (every value there is a valid point's score, so it bounds the
// final min and max as the block's own do) and refresh the skip threshold.
__device__ __forceinline__ void share_minmax(int* smin, int* smax, float* sthr,
                                             int* gmin, int* gmax) {
  const int mn = min(*smin, atomicMin(gmin, *smin));
  const int mx = max(*smax, atomicMax(gmax, *smax));
  *smin = mn;
  *smax = mx;
  *sthr = skip_threshold(mn, mx);
}

// Point slots kJ0..kJ1-1 of the thread's tile against the staged waypoints.
template <bool kCache, int kJ0, int kJ1>
__device__ __forceinline__ void scan_slots(const float (&px)[kPPT], const float (&py)[kPPT],
                                           const float (&pz)[kPPT], const bool (&inb)[kPPT],
                                           const bool (&ok)[kPPT], const float* swp, int nw,
                                           int* smin, int* smax, const float* sthr,
                                           const Cam& cam, const Consts& k,
                                           float* __restrict__ cache_w0, size_t N) {
  const int lane = threadIdx.x & 31;
  for (int wl = 0; wl < nw; ++wl) {
    float wr[12];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 v = reinterpret_cast<const float4*>(swp)[3 * wl + q];
      wr[4 * q] = v.x, wr[4 * q + 1] = v.y, wr[4 * q + 2] = v.z, wr[4 * q + 3] = v.w;
    }
    const int mn_run = smin[wl], mx_run = smax[wl];  // may be stale: then more pairs vote below
    const float thr = kCache ? 0.0f : sthr[wl];
    Prefix p[kPPT];
#pragma unroll
    for (int j = kJ0; j < kJ1; ++j) p[j] = tile_prefix(px[j], py[j], pz[j], wr, k);
    int lmin = 0x7fffffff, lmax = static_cast<int>(0x80000000u);
#pragma unroll
    for (int j = kJ0; j < kJ1; ++j) {
      // K1 writes every score; K1' needs a valid point's score unless t0
      // says it is inside [min, max]. A NaN t0 fails both tests below and
      // takes the whole score.
      const bool want = kCache ? inb[j] : (ok[j] && !(p[j].t0 > thr));
      if (!want) continue;
      float s = 0.0f;
      if (!(p[j].t0 >= kZeroT)) s = score(tile_rest(p[j], cam, k));
      if constexpr (kCache) cache_w0[(size_t)wl * N + j * kThreads] = s;
      if (ok[j]) {
        const bool nan = s != s;
        lmin = min(lmin, nan ? kNanMinBits : __float_as_int(s));
        lmax = max(lmax, nan ? kNanMaxBits : __float_as_int(s));
      }
    }
    // every lane votes; a warp that moves the min or max reduces over its
    // lanes and one lane updates the block's row
    if (__any_sync(kFullWarp, lmin < mn_run || lmax > mx_run)) {
      lmin = __reduce_min_sync(kFullWarp, lmin);
      lmax = __reduce_max_sync(kFullWarp, lmax);
      if (lane == 0) {
        atomicMin(&smin[wl], lmin);
        atomicMax(&smax[wl], lmax);
      }
    }
  }
}

// K1 (kCache) and K1'. K1 replaces pallas_vis.py _minmax_cache_kernel (pass A
// with score cache) and K1' _minmax_kernel (pass A, no cache). gmin and gmax
// are the final (W,) outputs as integer bits, preset by the wrapper to the
// sentinels 3e38 and -3e38 that a waypoint without valid points returns.
//
// Bound by the score's arithmetic (63 operations and 2 exp per (w, i) if all
// of it is computed) and, for K1, by the (W, N) cache write. What the design
// does about it:
//  - A persistent grid, as many blocks as the card holds at once, each
//    walking tiles blockIdx.x, + gridDim.x, ... of kBlockPts points. A tile's
//    points are read once into registers and every waypoint of the stage
//    (kStageW of them in shared memory; W > kStageW takes another sweep) is
//    evaluated against them.
//  - Running min and max per waypoint live in shared memory as integer bits
//    for the block's whole life (scores are >= +0, so integer order is float
//    order; the sentinels and the NaN marks fit that order too). A warp
//    touches them only when one of its scores would move them.
//  - After tile_prefix, t0 >= kZeroT gives s = +0 without the rest of the
//    score (K1 caches the 0). K1' also skips every pair with t0 above the
//    waypoint's skip_threshold, refreshed between tiles from the block's and
//    the grid's running values; a stale or smaller running max only skips
//    less. So that its first tile profits too, a block scans that tile's
//    first point slot, refreshes, and then scans the rest.
//  - The blocks merge into gmin/gmax with integer atomicMin/atomicMax: min
//    and max do not depend on the order, so two runs agree bit for bit.
// The rotation is deliberately not a tensor-core product: TF32 or BF16 inputs
// would change the score's bits, and the tie tests s == m of K3 and K5 hold
// only while every kernel and the plain version agree bit for bit.
template <bool kCache>
__global__ void __launch_bounds__(kThreads)
pass_a_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
              const float* __restrict__ wp, const float* __restrict__ kp, int N,
              int W, Consts k, float* __restrict__ cache, int* __restrict__ gmin,
              int* __restrict__ gmax) {
  __shared__ __align__(16) float swp[kStageW * 12];
  __shared__ int smin[kStageW], smax[kStageW];
  __shared__ float sthr[kStageW];
  const int tid = threadIdx.x;
  const Cam cam{kp[0], kp[1], kp[2], kp[3]};
  const int n_tiles = (N + kBlockPts - 1) / kBlockPts;

  for (int w0 = 0; w0 < W; w0 += kStageW) {
    const int nw = min(kStageW, W - w0);
    __syncthreads();  // the previous stage is fully read
    for (int t = tid; t < nw * 12; t += kThreads) swp[t] = wp[12 * (size_t)w0 + t];
    if (tid < nw) {
      smin[tid] = __float_as_int(kBig);
      smax[tid] = __float_as_int(-kBig);
    }
    const auto share = [&]() {
      __syncthreads();
      if (tid < nw) share_minmax(smin + tid, smax + tid, sthr + tid, gmin + w0 + tid, gmax + w0 + tid);
      __syncthreads();
    };

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int base = tile * kBlockPts + tid;
      float px[kPPT], py[kPPT], pz[kPPT];
      bool inb[kPPT], ok[kPPT];
#pragma unroll
      for (int j = 0; j < kPPT; ++j) {
        const int i = base + j * kThreads;
        inb[j] = i < N;
        px[j] = inb[j] ? pts[i] : 0.0f;
        py[j] = inb[j] ? pts[(size_t)N + i] : 0.0f;
        pz[j] = inb[j] ? pts[2 * (size_t)N + i] : 0.0f;
        ok[j] = inb[j] && valid[i] > 0.0f;
      }
      float* cache_w0 = kCache ? cache + (size_t)w0 * N + base : nullptr;
      share();
      if (!kCache && tile == blockIdx.x) {
        scan_slots<kCache, 0, 1>(px, py, pz, inb, ok, swp, nw, smin, smax, sthr, cam, k, cache_w0, N);
        share();
        scan_slots<kCache, 1, kPPT>(px, py, pz, inb, ok, swp, nw, smin, smax, sthr, cam, k, cache_w0, N);
      } else {
        scan_slots<kCache, 0, kPPT>(px, py, pz, inb, ok, swp, nw, smin, smax, sthr, cam, k, cache_w0, N);
      }
    }
    share();
  }
}

// Counts the floats x <= -kZeroT / 2 (from -inf up, every bit pattern) whose
// expf(x) is not 0: the premise of pass A's exact-zero pruning.
__global__ void __launch_bounds__(kThreads)
expf_zero_kernel(unsigned first_bits, unsigned long long n, unsigned long long* bad) {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = __uint_as_float((first_bits + static_cast<unsigned>(i)) | 0x80000000u);
    if (expf(x) != 0.0f) atomicAdd(bad, 1ull);
  }
}

// K2. Replaces pallas_vis.py _losum_cached_kernel (pass B from the cache).
// Bound by the (W, N) cache read (4 B per (w, i)); one log and one divide
// per element. One thread per point, waypoints summed in order 0..W-1.
__global__ void __launch_bounds__(kThreads)
pass_b_kernel(const float* __restrict__ cache, const float* __restrict__ norm,
              int N, int W, float hi, float* __restrict__ lo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float acc = 0.0f;
  for (int w = 0; w < W; ++w) {
    const float m = norm[4 * w], inv_d = norm[4 * w + 1];
    const float pn = clip_pn((cache[(size_t)w * N + i] - m) * inv_d, hi);
    acc += logf(pn / (1.0f - pn));
  }
  lo[i] = acc;
}

// K3. Replaces pallas_vis.py _bwd_stats_kernel (backward B1, cached).
// Bound by the cache read plus 4 B of g per point and chunk. Slots per w:
// [sum c_pn*dpn/dm, sum c_pn*dpn/dM, #(s == m), #(s == M)], counts over
// valid points; (n_blocks, W, 4) partials.
__global__ void __launch_bounds__(kThreads)
bwd_stats_kernel(const float* __restrict__ norm, const float* __restrict__ cache,
                 const float* __restrict__ valid, const float* __restrict__ g,
                 int N, int W, float hi, float* __restrict__ part) {
  __shared__ float ssum[kWarps][kWChunk][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kBlockPts;
  const int w0 = blockIdx.y * kWChunk;
  const int nw = min(kWChunk, W - w0);

  float gg[kPPT];
  bool inb[kPPT], ok[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int i = base + j * kThreads + tid;
    inb[j] = i < N;
    gg[j] = inb[j] ? g[i] : 0.0f;
    ok[j] = inb[j] && valid[i] > 0.0f;
  }

  for (int wl = 0; wl < nw; ++wl) {
    const int w = w0 + wl;
    const float m = norm[4 * w], inv_d = norm[4 * w + 1];
    const float gate = norm[4 * w + 2], mxv = norm[4 * w + 3];
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int j = 0; j < kPPT; ++j) {
      if (!inb[j]) continue;
      const float s = cache[(size_t)w * N + base + j * kThreads + tid];
      const float sm = s - m;
      const float c_pn = pn_cotangent(sm * inv_d, gg[j], hi);
      a0 += c_pn * (-inv_d + sm * inv_d * inv_d * gate);
      a1 += c_pn * (-(sm * inv_d * inv_d) * gate);
      a2 += (ok[j] && s == m) ? 1.0f : 0.0f;
      a3 += (ok[j] && s == mxv) ? 1.0f : 0.0f;
    }
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    a3 = warp_sum(a3);
    if (lane == 0) {
      ssum[warp][wl][0] = a0;
      ssum[warp][wl][1] = a1;
      ssum[warp][wl][2] = a2;
      ssum[warp][wl][3] = a3;
    }
  }
  __syncthreads();
  if (tid < nw * 4) {
    const int wl = tid >> 2, c = tid & 3;
    float acc = 0.0f;
    for (int q = 0; q < kWarps; ++q) acc += ssum[q][wl][c];
    part[((size_t)blockIdx.x * W + w0 + wl) * 4 + c] = acc;
  }
}

// K4. Replaces pallas_vis.py _bwd_apply_kernel (backward B2, cached).
// Bound by the cache read (the score is read back, not recomputed: no
// score exp) plus 20 B per point and chunk; ~80 flops and one exp (the
// sigmoid) per element. The cotangent c_pn*inv_d + alpha*[s==m] +
// beta*[s==M] is chained through the camera transform (_tile_dcam: the +-20
// clamp gated strictly, the z floor ignored) into 12 sums per w:
// [sum dc_c, sum dc_c*px, sum dc_c*py, sum dc_c*pz] for c = x, y, z;
// (n_blocks, W, 12) partials.
__global__ void __launch_bounds__(kThreads)
bwd_apply_kernel(const float* __restrict__ wp, const float* __restrict__ kp,
                 const float* __restrict__ norm2, const float* __restrict__ pts,
                 const float* __restrict__ valid, const float* __restrict__ g,
                 const float* __restrict__ cache, int N, int W, Consts k,
                 float hi, float* __restrict__ part) {
  __shared__ float ssum[kWarps][kWChunk][12];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kBlockPts;
  const int w0 = blockIdx.y * kWChunk;
  const int nw = min(kWChunk, W - w0);
  const Cam cam{kp[0], kp[1], kp[2], kp[3]};

  float px[kPPT], py[kPPT], pz[kPPT], gg[kPPT];
  bool inb[kPPT], ok[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int i = base + j * kThreads + tid;
    inb[j] = i < N;
    px[j] = inb[j] ? pts[i] : 0.0f;
    py[j] = inb[j] ? pts[(size_t)N + i] : 0.0f;
    pz[j] = inb[j] ? pts[2 * (size_t)N + i] : 0.0f;
    gg[j] = inb[j] ? g[i] : 0.0f;
    ok[j] = inb[j] && valid[i] > 0.0f;
  }

  for (int wl = 0; wl < nw; ++wl) {
    const int w = w0 + wl;
    const float* wrow = wp + 12 * w;
    const float* nrow = norm2 + 6 * w;
    const float m = nrow[0], inv_d = nrow[1], mxv = nrow[3];
    const float alpha = nrow[4], beta = nrow[5];
    float acc[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < kPPT; ++j) {
      if (!inb[j]) continue;
      const float s = cache[(size_t)w * N + base + j * kThreads + tid];
      const Extras e = tile_extras(px[j], py[j], pz[j], wrow, cam, k);
      const float c_pn = pn_cotangent((s - m) * inv_d, gg[j], hi);
      const float eqmin = (ok[j] && s == m) ? 1.0f : 0.0f;
      const float eqmax = (ok[j] && s == mxv) ? 1.0f : 0.0f;
      const float total = c_pn * inv_d + alpha * eqmin + beta * eqmax;
      const DcamFactors f = dcam_factors(e, cam, k);
      const float cs = total * s;
      const float dc[3] = {cs * f.bx, cs * f.by, cs * f.bz};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc[4 * c + 0] += dc[c];
        acc[4 * c + 1] += dc[c] * px[j];
        acc[4 * c + 2] += dc[c] * py[j];
        acc[4 * c + 3] += dc[c] * pz[j];
      }
    }
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      const float r = warp_sum(acc[c]);
      if (lane == 0) ssum[warp][wl][c] = r;
    }
  }
  __syncthreads();
  if (tid < nw * 12) {
    const int wl = tid / 12, c = tid % 12;
    float acc = 0.0f;
    for (int q = 0; q < kWarps; ++q) acc += ssum[q][wl][c];
    part[((size_t)blockIdx.x * W + w0 + wl) * 12 + c] = acc;
  }
}

// K2'. Replaces pallas_vis.py _losum_kernel (pass B recomputing the
// scores). Bound by the arithmetic: the score (~45 flops, 2 exp) and its clip
// on every (w, i), the divide, log and add only where pn > 0.5, against 16 B
// per point in all. A pair clipped to the 0.5 floor adds logf(0.5f / 0.5f)
// == +0 to a sum that is never -0, so skipping it keeps lo's bits; a NaN
// score, which the clip maps to 0.5, is skipped the same way. One thread
// holds kPPT points (independent dependency chains) and loops over all
// W in order (as K2 does); the waypoint table and (m, inv_d) of kStageW
// waypoints at a time are staged in shared memory for the whole block.
__global__ void __launch_bounds__(kThreads)
pass_b_recompute_kernel(const float* __restrict__ wp, const float* __restrict__ kp,
                        const float* __restrict__ norm, const float* __restrict__ pts,
                        int N, int W, Consts k, float hi, float* __restrict__ lo) {
  __shared__ float swp[kStageW * 12];
  __shared__ float snorm[kStageW * 2];
  const int base = blockIdx.x * kBlockPts + threadIdx.x;
  const Cam cam{kp[0], kp[1], kp[2], kp[3]};
  float px[kPPT], py[kPPT], pz[kPPT], acc[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int i = base + j * kThreads;
    const bool inb = i < N;
    px[j] = inb ? pts[i] : 0.0f;
    py[j] = inb ? pts[(size_t)N + i] : 0.0f;
    pz[j] = inb ? pts[2 * (size_t)N + i] : 0.0f;
    acc[j] = 0.0f;
  }

  for (int w0 = 0; w0 < W; w0 += kStageW) {
    const int nw = min(kStageW, W - w0);
    __syncthreads();  // the previous stage is fully read
    for (int t = threadIdx.x; t < nw * 12; t += kThreads) swp[t] = wp[12 * (size_t)w0 + t];
    for (int t = threadIdx.x; t < nw; t += kThreads) {
      snorm[2 * t] = norm[4 * (size_t)(w0 + t)];
      snorm[2 * t + 1] = norm[4 * (size_t)(w0 + t) + 1];
    }
    __syncthreads();
    for (int wl = 0; wl < nw; ++wl) {
      const float m = snorm[2 * wl], inv_d = snorm[2 * wl + 1];
#pragma unroll
      for (int j = 0; j < kPPT; ++j) {
        const float s = score(tile_extras(px[j], py[j], pz[j], swp + 12 * wl, cam, k));
        const float pn_raw = (s - m) * inv_d;
        if (pn_raw > 0.5f) {
          const float pn = fminf(pn_raw, hi);  // == clip_pn(pn_raw, hi) here
          acc[j] += logf(pn / (1.0f - pn));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int i = base + j * kThreads;
    if (i < N) lo[i] = acc[j];
  }
}

// K5. Replaces pallas_vis.py _bwd_kernel (single-pass backward, no cache).
// Slots per w, the JAX twin's layout (pallas_vis.py BWD_SLOTS):
//   0:12  direct channel, cotangent c_pn * inv_d
//   12:24 min-tie channel, cotangent 1[valid, s == m]
//   24:36 max-tie channel, cotangent 1[valid, s == M]
//         each [sum dc_c, sum dc_c*px, sum dc_c*py, sum dc_c*pz], c = x, y, z
//   36 sum c_pn*dpn/dm, 37 sum c_pn*dpn/dM, 38 #(s == m), 39 #(s == M)
// (n_blocks, W, 40) partials.
//
// Bound by the arithmetic. Every (w, i) needs its score (~45 flops, 2 exp),
// the clip-window test and the two tie tests; the gradient chain (the dcam
// factors and ~80 flops into 38 sums) is needed only where a term can be
// nonzero. A term is cot * s * f with f finite for finite inputs (|inv_zd|
// <= 1e12, xu and xv clamped to +-20), so it is exactly zero when
//   direct channel, slots 36/37: pn is outside the strict clip window (c_pn
//     == 0), unless s is NaN;
//   tie channels: the pair ties neither m nor M, or ties with s == 0 (every
//     far point ties a minimum that has underflowed to 0), unless s is NaN.
// On a large map nearly every pair is such a pair. So each warp votes
// (__any_sync, every lane voting, ragged-edge lanes with a false predicate)
// per waypoint and point slot, and runs a chain only when one of its lanes
// needs it; lanes that do not contribute an exact 0. The direct channel and
// slots 36/37 keep 14 per-lane sums across the thread's kPPT points and go
// through one warp reduction per waypoint, only if the warp took the branch;
// the tie channels, taken almost never, are reduced inside their branch and
// added to shared memory by lane 0. The tie counts come from
// __popc(__ballot_sync) on every pair and stay exact integers. Every order
// is fixed (waypoint, point slot, warp), so a run is reproducible bit for
// bit.
__global__ void __launch_bounds__(kThreads)
bwd_fused_kernel(const float* __restrict__ wp, const float* __restrict__ kp,
                 const float* __restrict__ norm, const float* __restrict__ pts,
                 const float* __restrict__ valid, const float* __restrict__ g,
                 int N, int W, Consts k, float hi, float* __restrict__ part) {
  __shared__ float ssum[kWarps][kWChunk][kBwdSlots];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kBlockPts;
  const int w0 = blockIdx.y * kWChunk;
  const int nw = min(kWChunk, W - w0);
  const Cam cam{kp[0], kp[1], kp[2], kp[3]};

  for (int t = tid; t < kWarps * kWChunk * kBwdSlots; t += kThreads) (&ssum[0][0][0])[t] = 0.0f;
  __syncthreads();  // below, only lane 0 of warp q writes ssum[q]

  float px[kPPT], py[kPPT], pz[kPPT], gg[kPPT];
  bool inb[kPPT], ok[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int i = base + j * kThreads + tid;
    inb[j] = i < N;
    px[j] = inb[j] ? pts[i] : 0.0f;
    py[j] = inb[j] ? pts[(size_t)N + i] : 0.0f;
    pz[j] = inb[j] ? pts[2 * (size_t)N + i] : 0.0f;
    gg[j] = inb[j] ? g[i] : 0.0f;
    ok[j] = inb[j] && valid[i] > 0.0f;
  }

  for (int wl = 0; wl < nw; ++wl) {
    const int w = w0 + wl;
    const float* wrow = wp + 12 * w;
    const float m = norm[4 * w], inv_d = norm[4 * w + 1];
    const float gate = norm[4 * w + 2], mxv = norm[4 * w + 3];
    float* tie_sums = ssum[warp][wl] + 12;
    float acc[14];  // direct channel 0:12, then slots 36 and 37
#pragma unroll
    for (int c = 0; c < 14; ++c) acc[c] = 0.0f;
    bool took_direct = false;
    int n_min = 0, n_max = 0;
#pragma unroll
    for (int j = 0; j < kPPT; ++j) {
      const Extras e = tile_extras(px[j], py[j], pz[j], wrow, cam, k);
      const float s = score(e);
      const float sm = s - m;
      const float pn_raw = sm * inv_d;
      const bool nan = isnan(s);
      const bool eqmin = ok[j] && s == m;
      const bool eqmax = ok[j] && s == mxv;
      const bool direct = inb[j] && ((pn_raw > 0.5f && pn_raw < hi) || nan);
      const bool tie = inb[j] && (((eqmin || eqmax) && s != 0.0f) || nan);
      n_min += __popc(__ballot_sync(kFullWarp, eqmin));
      n_max += __popc(__ballot_sync(kFullWarp, eqmax));
      const bool any_direct = __any_sync(kFullWarp, direct);
      const bool any_tie = __any_sync(kFullWarp, tie);
      if (!(any_direct || any_tie)) continue;
      const DcamFactors f = dcam_factors(e, cam, k);
      if (any_direct) {
        took_direct = true;
        const float c_pn = pn_cotangent(pn_raw, gg[j], hi);
        const float cs = direct ? c_pn * inv_d * s : 0.0f;
        const float dc[3] = {cs * f.bx, cs * f.by, cs * f.bz};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[4 * c + 0] += dc[c];
          acc[4 * c + 1] += dc[c] * px[j];
          acc[4 * c + 2] += dc[c] * py[j];
          acc[4 * c + 3] += dc[c] * pz[j];
        }
        acc[12] += direct ? c_pn * (-inv_d + sm * inv_d * inv_d * gate) : 0.0f;
        acc[13] += direct ? c_pn * (-(sm * inv_d * inv_d) * gate) : 0.0f;
      }
      if (any_tie) {
        const float cs[2] = {tie ? (eqmin ? 1.0f : 0.0f) * s : 0.0f,
                             tie ? (eqmax ? 1.0f : 0.0f) * s : 0.0f};
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          const float dc[3] = {cs[ch] * f.bx, cs[ch] * f.by, cs[ch] * f.bz};
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float v[4] = {dc[c], dc[c] * px[j], dc[c] * py[j], dc[c] * pz[j]};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float r = warp_sum(v[q]);
              if (lane == 0) tie_sums[12 * ch + 4 * c + q] += r;
            }
          }
        }
      }
    }
    if (took_direct) {
#pragma unroll
      for (int c = 0; c < 14; ++c) acc[c] = warp_sum(acc[c]);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 12; ++c) ssum[warp][wl][c] = acc[c];
      ssum[warp][wl][36] = acc[12];
      ssum[warp][wl][37] = acc[13];
      ssum[warp][wl][38] = static_cast<float>(n_min);
      ssum[warp][wl][39] = static_cast<float>(n_max);
    }
  }
  __syncthreads();
  for (int t = tid; t < nw * kBwdSlots; t += kThreads) {
    const int wl = t / kBwdSlots, c = t % kBwdSlots;
    float acc = 0.0f;
    for (int q = 0; q < kWarps; ++q) acc += ssum[q][wl][c];
    part[((size_t)blockIdx.x * W + w0 + wl) * kBwdSlots + c] = acc;
  }
}

inline Consts make_consts(float c0, float inv_var, float img_w, float img_h,
                          float eps, float inv_w, float inv_h) {
  return Consts{c0, inv_var, img_w, img_h, eps, inv_w, inv_h};
}

inline dim3 chunk_grid(int N, int W) {
  return dim3((N + kBlockPts - 1) / kBlockPts, (W + kWChunk - 1) / kWChunk);
}

// Pass A's persistent grid: as many blocks as the card holds at once (SMs x
// resident blocks of this kernel, asked once per device), or fewer so that
// every block walks the same number of tiles, give or take one.
template <bool kCache>
int launch_pass_a(const float* pts, const float* valid, const float* wp, const float* kp,
                  int N, int W, Consts k, float* cache, float* mn, float* mx, void* stream) {
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int cap = dev < kMaxDevices ? resident[dev] : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pass_a_kernel<kCache>,
                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap = sms * per_sm > 0 ? sms * per_sm : 1;
    if (dev < kMaxDevices) resident[dev] = cap;
  }
  const int n_tiles = (N + kBlockPts - 1) / kBlockPts;
  const int rounds = (n_tiles + cap - 1) / cap;
  const int grid = (n_tiles + rounds - 1) / rounds;
  pass_a_kernel<kCache><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, valid, wp, kp, N, W, k, cache, reinterpret_cast<int*>(mn),
      reinterpret_cast<int*>(mx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fv_block_points() { return kBlockPts; }

const char* fv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fv_pass_a(const float* pts, const float* valid, const float* wp,
              const float* kp, int N, int W, float c0, float inv_var,
              float img_w, float img_h, float eps, float inv_w, float inv_h,
              float* cache, float* mn, float* mx, void* stream) {
  return launch_pass_a<true>(pts, valid, wp, kp, N, W,
                             make_consts(c0, inv_var, img_w, img_h, eps, inv_w, inv_h), cache,
                             mn, mx, stream);
}

int fv_pass_b(const float* cache, const float* norm, int N, int W, float hi,
              float* lo, void* stream) {
  pass_b_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(cache, norm, N, W, hi, lo);
  return static_cast<int>(cudaGetLastError());
}

int fv_bwd_stats(const float* norm, const float* cache, const float* valid,
                 const float* g, int N, int W, float hi, float* part,
                 void* stream) {
  bwd_stats_kernel<<<chunk_grid(N, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      norm, cache, valid, g, N, W, hi, part);
  return static_cast<int>(cudaGetLastError());
}

int fv_bwd_apply(const float* wp, const float* kp, const float* norm2,
                 const float* pts, const float* valid, const float* g,
                 const float* cache, int N, int W, float c0, float inv_var,
                 float img_w, float img_h, float eps, float inv_w, float inv_h,
                 float hi, float* part, void* stream) {
  bwd_apply_kernel<<<chunk_grid(N, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      wp, kp, norm2, pts, valid, g, cache, N, W,
      make_consts(c0, inv_var, img_w, img_h, eps, inv_w, inv_h), hi, part);
  return static_cast<int>(cudaGetLastError());
}

int fv_pass_a_minmax(const float* pts, const float* valid, const float* wp,
                     const float* kp, int N, int W, float c0, float inv_var,
                     float img_w, float img_h, float eps, float inv_w, float inv_h,
                     float* mn, float* mx, void* stream) {
  return launch_pass_a<false>(pts, valid, wp, kp, N, W,
                              make_consts(c0, inv_var, img_w, img_h, eps, inv_w, inv_h),
                              nullptr, mn, mx, stream);
}

float fv_prune_zero_t() { return kZeroT; }
float fv_prune_max_margin() { return kMaxMargin; }
float fv_prune_max_floor() { return kMaxFloor; }

// *bad (device, preset to 0) receives the count of floats x <= -kZeroT / 2
// with expf(x) != 0; *n_checked (host) the number of floats tried.
int fv_expf_zero_check(unsigned long long* bad, unsigned long long* n_checked, void* stream) {
  const float first = kZeroT * 0.5f;
  unsigned first_bits;
  memcpy(&first_bits, &first, sizeof first_bits);
  *n_checked = 0x7f800000u - first_bits + 1ull;  // up to and including -inf
  expf_zero_kernel<<<4096, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(first_bits,
                                                                            *n_checked, bad);
  return static_cast<int>(cudaGetLastError());
}

int fv_pass_b_recompute(const float* wp, const float* kp, const float* norm,
                        const float* pts, int N, int W, float c0, float inv_var,
                        float img_w, float img_h, float eps, float inv_w, float inv_h,
                        float hi, float* lo, void* stream) {
  pass_b_recompute_kernel<<<(N + kBlockPts - 1) / kBlockPts, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      wp, kp, norm, pts, N, W, make_consts(c0, inv_var, img_w, img_h, eps, inv_w, inv_h),
      hi, lo);
  return static_cast<int>(cudaGetLastError());
}

int fv_bwd_fused_acc(const float* wp, const float* kp, const float* norm,
                     const float* pts, const float* valid, const float* g, int N,
                     int W, float c0, float inv_var, float img_w, float img_h,
                     float eps, float inv_w, float inv_h, float hi, float* part,
                     void* stream) {
  bwd_fused_kernel<<<chunk_grid(N, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      wp, kp, norm, pts, valid, g, N, W,
      make_consts(c0, inv_var, img_w, img_h, eps, inv_w, inv_h), hi, part);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
