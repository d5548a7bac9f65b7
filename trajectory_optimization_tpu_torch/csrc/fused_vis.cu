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
// Grid for K5: blockIdx.x over blocks of kBlockPts points (kPPT per thread,
// neighbouring threads on neighbouring points), blockIdx.y over chunks of
// kWChunk waypoints, a loop over the chunk's waypoints inside the block;
// per-block results go to (n_blocks, W, 40) partials that the wrapper reduces
// with torch.sum. K3 walks several point tiles per block and waypoint chunk,
// K4 walks the need mask that K3 leaves (one warp per waypoint and range of
// mask words); both finish their partials themselves, in the last block to
// arrive (last_to_arrive). No float atomics anywhere, so a run is reproducible
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
// The cached K2 and K3 are bound by device-memory bandwidth, not arithmetic:
// at 1M points x 50 waypoints each reads the 200 MB cache that K1 wrote,
// against a few operations per (w, i). K3 answers with 16-byte loads started
// ahead of their use and per-lane sums that are reduced once per block; it
// also leaves one bit per pair that says whether the pair can add a nonzero
// term to K4, so K4 reads that mask (W * N / 8 bytes) and only the pairs it
// flags. K2' and K5 read 16-20 B per point (and waypoint chunk) and are bound
// by the recompute arithmetic instead. K2', K4 and K5 compute only what can be
// nonzero: outside the strict clip window (0.5, 1 - eps) a pair's log term
// and direct gradient terms are exactly zero, as is a min or max tie's term
// when its score is 0, and on a large map that is nearly every pair.
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

// The last block of a group to arrive (one group per arrival counter) finishes
// the group's reduction. Every block of the group writes its partial sums,
// fences, and takes a ticket from the group's counter with an integer atomic;
// the block that draws the last ticket sees every partial, sums them in a
// fixed order (sum_parts) and puts the counter back to 0 for the next call.
// No float atomics, no second launch, and two runs agree bit for bit.
// Must be reached by all threads of the block; the threads that wrote the
// block's partials have each passed a __threadfence() after their stores.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n_blocks) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == n_blocks - 1;
  }
  __syncthreads();
  if (last) __threadfence();  // the other blocks' partials, not a stale line
  return last;
}

// One output of a final reduction: kSubLanes neighbouring lanes share it,
// lane `sub` sums the partials sub, sub + kSubLanes, ... in that order and a
// fixed shuffle tree adds the lanes up. Every lane of the warp must call it
// (with n_parts == 0 where it has no output). Partials are doubles, sums and
// counts alike (a count is exact in a double), and the result is rounded to
// f32 by the caller, once.
constexpr int kSubLanes = 8;

__device__ __forceinline__ double sum_parts(const double* part, int n_parts, size_t stride) {
  const int sub = threadIdx.x % kSubLanes;
  double f = 0.0;
  for (int x = sub; x < n_parts; x += kSubLanes)
    f += __ldcg(part + (size_t)x * stride);  // from L2: written by other blocks
#pragma unroll
  for (int o = kSubLanes / 2; o > 0; o >>= 1) f += __shfl_xor_sync(kFullWarp, f, o);
  return f;
}

// K3. Replaces pallas_vis.py _bwd_stats_kernel (backward B1, cached).
// Outputs per w: [sum c_pn*dpn/dm, sum c_pn*dpn/dM, #(s == m), #(s == M)],
// counts over valid points, and the need mask for K4: bit l of word j of row
// w is set iff pair (w, 32 j + l) can add a nonzero term there, i.e. it lies
// inside the strict clip window (c_pn != 0), or its score is not finite, or
// it is a valid min or max tie with s != 0. Every other pair's term is
// total * s * f with total == 0 or s == 0 and f finite: exactly zero. The
// mask does not depend on g. Every word of need is written, bits of points
// i >= N are 0.
//
// Bound by the one read of the (W, N) cache (plus the N/8 bytes of mask per
// waypoint it writes), with ~12 operations per pair to hide under it. What
// the design does:
//  - A block owns kWChunk waypoints and walks point tiles blockIdx.x, +
//    gridDim.x, ...; the grid is one wave of resident blocks. Scores are
//    loaded kStatsStage waypoints at a time (16 bytes per thread and
//    waypoint on the vector path) into one of two register buffers: while a
//    stage is worked on, the next stage's 64 bytes per thread are in flight.
//  - Nearly every warp of a large map holds only scores far under the clip
//    window. Per waypoint, window_floor gives the exact floor of the window
//    in score space; a warp whose |s| all lie under it has need word 0 and
//    only its ties with a min of 0 to count: 4 operations per pair
//    instead of 13, after one vote.
//  - Tie counts are per-lane integers that live across all of the block's
//    tiles and are reduced over the warp once per block.
//  - The two float sums are zero unless a pair is inside the clip window or
//    its score is not finite, so a warp votes (on the need bits it has just
//    made) and takes them only where one of its lanes needs them. They are
//    kept per thread and waypoint as doubles in shared memory, out of the
//    registers of the common path, and rounded to f32 once per block: sums
//    that cancel then depend on the summation order by far less than an f32
//    rounding, which the 400-step optimization is sensitive to.
//  - kVec: a thread holds 4 neighbouring points and loads float4 (N % 4 == 0
//    and 16-byte aligned pointers, decided by the launcher); a warp then
//    covers 4 mask words, 8 lanes each, put together with 3 shuffles. The
//    scalar path holds points tid, tid + 256, ... and a ballot is the word.
//  - The (gridDim.x, W, 4) partials are finished by the last block of each
//    waypoint chunk to arrive (last_to_arrive).
constexpr int kStatsStage = 4;  // waypoints whose loads are started together
constexpr float kFltMax = 3.402823466e+38f;
static_assert(kThreads / kSubLanes == kWChunk * 4, "one final-reduction output per 8 lanes");
static_assert(kBlockPts == 1024 && kPPT == 4, "a tile is 32 mask words, 4 per warp");

// The smallest non-negative float s with fl(fl(s - m) * inv_d) > 0.5, the
// floor of the clip window (+inf if there is none). The rounded subtraction
// and the multiplication by a positive factor are monotone in s, so no score
// with |s| below it is inside the window; found by bisection on the bits.
// 0, under which nothing lies, where inv_d is not positive and finite or m is
// not finite.
__device__ float window_floor(float m, float inv_d) {
  if (!(inv_d > 0.0f && inv_d <= kFltMax && fabsf(m) <= kFltMax)) return 0.0f;
  unsigned lo = 0u, up = 0x7f800000u;  // the answer's bits lie in [lo, up]; up is +inf
  while (lo < up) {
    const unsigned mid = lo + (up - lo) / 2;
    if ((__uint_as_float(mid) - m) * inv_d > 0.5f)
      up = mid;
    else
      lo = mid + 1;
  }
  return __uint_as_float(lo);
}

template <int kS0>
struct Stage {
  static constexpr int value = kS0;
};
static_assert(kWChunk == 2 * kStatsStage, "a chunk is two stages");

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bwd_stats_kernel(const float* __restrict__ norm, const float* __restrict__ cache,
                 const float* __restrict__ valid, const float* __restrict__ g,
                 int N, int W, float hi, int n_words, double* part, int* arrivals,
                 float* __restrict__ out, unsigned* __restrict__ need) {
  __shared__ __align__(16) float snorm[kWChunk][4];
  __shared__ float sfloor[kWChunk];  // see the fast path in process
  __shared__ int ssame[kWChunk];
  __shared__ double ssum[kWarps][kWChunk][4];
  __shared__ double sacc[2][kWChunk][kThreads];  // [dm, dM] per waypoint and thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = blockIdx.y * kWChunk;
  const int nw = min(kWChunk, W - w0);
  if (tid < nw * 4) (&snorm[0][0])[tid] = norm[4 * (size_t)w0 + tid];
  if (tid < nw) {
    // Scores with |s| under the waypoint's floor are outside the clip window
    // and finite. If besides they can tie the min only where it is 0 (no
    // need bit) and the max only where both are 0, a warp of such scores has
    // nothing to do but count its min ties: the floor is kept, else 0.
    const float m = norm[4 * (size_t)(w0 + tid)], inv_d = norm[4 * (size_t)(w0 + tid) + 1];
    const float mxv = norm[4 * (size_t)(w0 + tid) + 3];
    const float floor_s = window_floor(m, inv_d);
    const bool min_quiet = m == 0.0f || !(fabsf(m) < floor_s);
    const bool max_quiet = (m == 0.0f && mxv == 0.0f) || !(fabsf(mxv) < floor_s);
    sfloor[tid] = min_quiet && max_quiet ? floor_s : 0.0f;
    ssame[tid] = m == 0.0f && mxv == 0.0f;  // then a score of 0 ties both
  }
#pragma unroll
  for (int wl = 0; wl < kWChunk; ++wl) sacc[0][wl][tid] = sacc[1][wl][tid] = 0.0;
  __syncthreads();
  const int n_tiles = (N + kBlockPts - 1) / kBlockPts;

  int n_min[kWChunk], n_max[kWChunk];
#pragma unroll
  for (int wl = 0; wl < kWChunk; ++wl) n_min[wl] = n_max[wl] = 0;

  // The thread's kPPT points of a tile: neighbours (kVec) or a block's width
  // apart. g and valid of those points, and whether they exist:
  struct Meta {
    float gg[kPPT];
    bool inb[kPPT], ok[kPPT];
  };
  constexpr int kStep = kVec ? 1 : kThreads;
  const auto first_of = [&](int tile) {
    return tile * kBlockPts + (kVec ? 128 * warp + 4 * lane : tid);
  };
  const auto load_meta = [&](int tile, Meta& mt) {
    const int first = first_of(tile);
    if constexpr (kVec) {
      const bool in = first < N;  // N % 4 == 0: all four or none
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 g4 = in ? *reinterpret_cast<const float4*>(g + first) : zero;
      const float4 v4 = in ? *reinterpret_cast<const float4*>(valid + first) : zero;
      mt.gg[0] = g4.x, mt.gg[1] = g4.y, mt.gg[2] = g4.z, mt.gg[3] = g4.w;
      const float vv[kPPT] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int c = 0; c < kPPT; ++c) mt.inb[c] = in, mt.ok[c] = in && vv[c] > 0.0f;
    } else {
#pragma unroll
      for (int c = 0; c < kPPT; ++c) {
        const int i = first + c * kStep;
        mt.inb[c] = i < N;
        mt.gg[c] = mt.inb[c] ? g[i] : 0.0f;
        mt.ok[c] = mt.inb[c] && valid[i] > 0.0f;
      }
    }
  };
  // The scores of waypoints s0 .. s0 + kStatsStage - 1 of the chunk at those
  // points: all loads started before any is used.
  const auto load_rows = [&](int tile, int s0, float (&s)[kStatsStage][kPPT]) {
    const int first = first_of(tile);
#pragma unroll
    for (int q = 0; q < kStatsStage; ++q) {
      const bool row_ok = s0 + q < nw;
      const float* row = cache + (size_t)(w0 + (row_ok ? s0 + q : 0)) * N;
      if constexpr (kVec) {
        const float4 s4 = row_ok && first < N ? *reinterpret_cast<const float4*>(row + first)
                                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        s[q][0] = s4.x, s[q][1] = s4.y, s[q][2] = s4.z, s[q][3] = s4.w;
      } else {
#pragma unroll
        for (int c = 0; c < kPPT; ++c) {
          const int i = first + c * kStep;
          s[q][c] = row_ok && i < N ? row[i] : 0.0f;
        }
      }
    }
  };
  // Waypoints kS0 .. of the chunk on one tile: counts, need words, float sums.
  const auto process = [&](auto s0_const, int tile, const float (&s)[kStatsStage][kPPT],
                           const Meta& mt) {
    constexpr int kS0 = decltype(s0_const)::value;
#pragma unroll
    for (int q = 0; q < kStatsStage; ++q) {
      const int wl = kS0 + q;
      if (wl >= nw) break;
      const float4 nrm = *reinterpret_cast<const float4*>(snorm[wl]);
      const float m = nrm.x, inv_d = nrm.y, gate = nrm.z, mxv = nrm.w;
      unsigned* need_row = need + (size_t)(w0 + wl) * n_words;
      // The fast path, taken by nearly every warp of a large map: all its
      // scores lie under the floor, so every need bit is 0 and only min ties
      // (and max ties, where m == M == 0) are counted. NaN and inf fail it.
      const float floor_s = sfloor[wl];
      bool quiet = true;
      int ties = 0;
#pragma unroll
      for (int c = 0; c < kPPT; ++c) {
        quiet &= fabsf(s[q][c]) < floor_s;
        ties += mt.ok[c] && s[q][c] == m;
      }
      n_min[wl] += ties;
      if (__all_sync(kFullWarp, quiet)) {
        n_max[wl] += ssame[wl] ? ties : 0;
        if constexpr (kVec) {
          const int j = tile * (kBlockPts / 32) + 4 * warp + (lane >> 3);
          if ((lane & 7) == 0 && j < n_words) need_row[j] = 0u;
        } else {
          const int j = tile * (kBlockPts / 32) + lane * kWarps + warp;
          if (lane < kPPT && j < n_words) need_row[j] = 0u;
        }
        continue;
      }
      // a tie has s != 0 exactly when the min or max it ties is not 0
      const bool m_nz = m != 0.0f, mx_nz = mxv != 0.0f;
      unsigned nib = 0;  // the need bits of the thread's kPPT points
#pragma unroll
      for (int c = 0; c < kPPT; ++c) {
        const float sv = s[q][c];
        const float pn_raw = (sv - m) * inv_d;
        const bool act = mt.inb[c] && ((pn_raw > 0.5f && pn_raw < hi) || !(fabsf(sv) <= kFltMax));
        const bool eqmin = mt.ok[c] && sv == m, eqmax = mt.ok[c] && sv == mxv;
        n_max[wl] += eqmax;
        nib |= (act || (eqmin && m_nz) || (eqmax && mx_nz)) ? 1u << c : 0u;
      }
      // the float sums: only pairs inside the window or not finite add to
      // them, and those have their need bit set (a tie adds an exact 0)
      if (__any_sync(kFullWarp, nib != 0u)) {
        float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
        for (int c = 0; c < kPPT; ++c) {
          // each operation rounded on its own, in the plain version's order:
          // the terms do not depend on what the compiler contracts
          const float sm = s[q][c] - m;
          const float c_pn = pn_cotangent(sm * inv_d, mt.gg[c], hi);
          const float curve = mul(mul(sm, inv_d), inv_d);  // d pn / d span, but for its sign
          const float dm = mul(c_pn, add(-inv_d, mul(curve, gate)));
          const float dM = mul(c_pn, mul(-curve, gate));
          t0 = add(t0, mt.inb[c] ? dm : 0.0f);
          t1 = add(t1, mt.inb[c] ? dM : 0.0f);
        }
        sacc[0][wl][tid] += static_cast<double>(t0);
        sacc[1][wl][tid] += static_cast<double>(t1);
      }
      if constexpr (kVec) {
        unsigned word = nib << (4 * (lane & 7));
        word |= __shfl_xor_sync(kFullWarp, word, 1);
        word |= __shfl_xor_sync(kFullWarp, word, 2);
        word |= __shfl_xor_sync(kFullWarp, word, 4);
        const int j = tile * (kBlockPts / 32) + 4 * warp + (lane >> 3);
        if ((lane & 7) == 0 && j < n_words) need_row[j] = word;
      } else {
        unsigned word = 0;
#pragma unroll
        for (int c = 0; c < kPPT; ++c) {
          const unsigned b = __ballot_sync(kFullWarp, (nib >> c) & 1u);
          if (lane == c) word = b;
        }
        const int j = tile * (kBlockPts / 32) + lane * kWarps + warp;
        if (lane < kPPT && j < n_words) need_row[j] = word;
      }
    }
  };

  // Two buffers of scores: while one stage is worked on, the next stage's
  // loads (the chunk's other kStatsStage waypoints, or the next tile's first)
  // are in flight, so the memory system never waits for the arithmetic.
  float sa[kStatsStage][kPPT], sb[kStatsStage][kPPT];
  Meta mt, mt_next;
  int tile = blockIdx.x;
  if (tile < n_tiles) {
    load_meta(tile, mt);
    load_rows(tile, 0, sa);
  }
  for (; tile < n_tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (nw > kStatsStage) load_rows(tile, kStatsStage, sb);
    process(Stage<0>{}, tile, sa, mt);
    if (next < n_tiles) {
      load_meta(next, mt_next);
      load_rows(next, 0, sa);
    }
    if (nw > kStatsStage) process(Stage<kStatsStage>{}, tile, sb, mt);
    mt = mt_next;
  }

#pragma unroll
  for (int wl = 0; wl < kWChunk; ++wl) {
    if (wl >= nw) break;
    double r0 = sacc[0][wl][tid], r1 = sacc[1][wl][tid];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      r0 += __shfl_xor_sync(kFullWarp, r0, o);
      r1 += __shfl_xor_sync(kFullWarp, r1, o);
    }
    const int c0 = __reduce_add_sync(kFullWarp, n_min[wl]);
    const int c1 = __reduce_add_sync(kFullWarp, n_max[wl]);
    if (lane == 0) {
      ssum[warp][wl][0] = r0;
      ssum[warp][wl][1] = r1;
      ssum[warp][wl][2] = c0;
      ssum[warp][wl][3] = c1;
    }
  }
  __syncthreads();
  if (tid < nw * 4) {
    double f = 0.0;
    for (int q = 0; q < kWarps; ++q) f += ssum[q][tid >> 2][tid & 3];
    part[((size_t)blockIdx.x * W + w0) * 4 + tid] = f;
    __threadfence();
  }
  if (!last_to_arrive(arrivals + blockIdx.y, gridDim.x)) return;
  const int o = tid / kSubLanes;  // output wl * 4 + c of this waypoint chunk
  const double r = sum_parts(part + (size_t)w0 * 4 + o, o < nw * 4 ? gridDim.x : 0, (size_t)W * 4);
  if (tid % kSubLanes == 0 && o < nw * 4) out[(size_t)w0 * 4 + o] = static_cast<float>(r);
  if (tid == 0) arrivals[blockIdx.y] = 0;
}

// K4. Replaces pallas_vis.py _bwd_apply_kernel (backward B2, cached).
// The cotangent total = c_pn*inv_d + alpha*[s==m] + beta*[s==M] is chained
// through the camera transform (_tile_dcam: the +-20 clamp gated strictly,
// the z floor ignored) into 12 sums per w: [sum dc_c, sum dc_c*px, sum
// dc_c*py, sum dc_c*pz] for c = x, y, z; the score is read back from the
// cache, not recomputed, so the tie tests see the bits K3 saw.
//
// A pair's term is total * s * f, and K3 has left a bit per pair that says
// whether it can be nonzero (see there). So this kernel walks the mask, not
// the cache: it is bound by the W * N / 8 bytes of mask plus, per flagged
// pair, the chain's ~141 operations and the 28 bytes of score, point, g and
// valid. What the design does:
//  - A warp owns one waypoint and a contiguous range of mask words, so the
//    waypoint's row of wp and norm2 and the 12 sums stay in registers. It
//    reads the range 32 words at a time (coalesced) and skips a batch
//    without a set bit after one vote.
//  - Flagged pairs are compacted before the chain runs: the lanes write the
//    point indices of their words' set bits into the warp's queue in shared
//    memory (a prefix sum over the lanes gives each its place, so the order
//    is that of the points), and the warp takes 32 indices at a time, one
//    pair per lane. On a large map a flagged 32-point group holds one or two
//    pairs, so without this the chain would run with one lane in 32 at work;
//    on a dense cloud the indices are neighbours and the loads coalesce.
//  - The range (words per warp, a multiple of 32) is chosen by the launcher
//    so that the card is filled whether the rows are short (the reference
//    cloud: 1,280 words per row) or long.
//  - A block's 8 warps are 8 neighbouring ranges of one waypoint; their sums
//    are added in warp order into one partial per block, and the last block
//    of the waypoint to arrive adds the partials (last_to_arrive).
//  - The 12 sums cancel heavily (a result of order 1 from terms whose
//    magnitudes add up to 1e6 on a dense cloud), and a lane may add hundreds
//    of terms. The terms are the f32 chain's (dc_c and its products with
//    the point, each rounded to f32 as the plain version's are); they are
//    added in double, by the lane and by everything above it (the warp, the
//    block, the partials), and the result is rounded to f32 once, at the
//    end: it is the sum of the terms to an f32 rounding of the result,
//    whatever the order, where an f32 sum is off by roundings of the
//    magnitudes.
//  - alpha or beta not finite: total is NaN for every pair of the waypoint
//    (alpha * 0), flagged or not, so the final reduction writes NaN to all
//    12 sums, as the full computation gives.
constexpr int kQueue = 32 * 32 + 32;  // a batch's pairs and what the last one left

__global__ void __launch_bounds__(kThreads)
bwd_apply_kernel(const float* __restrict__ wp, const float* __restrict__ kp,
                 const float* __restrict__ norm2, const float* __restrict__ pts,
                 const float* __restrict__ valid, const float* __restrict__ g,
                 const float* __restrict__ cache, const unsigned* __restrict__ need,
                 int N, int W, Consts k, float hi, int n_words, int range, double* part,
                 int* arrivals, float* __restrict__ out) {
  __shared__ double ssum[kWarps][12];
  __shared__ int squeue[kWarps][kQueue];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = blockIdx.y;
  const Cam cam{kp[0], kp[1], kp[2], kp[3]};
  const float* nrow = norm2 + 6 * (size_t)w;
  const float m = nrow[0], inv_d = nrow[1], mxv = nrow[3], alpha = nrow[4], beta = nrow[5];
  float wrow[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) wrow[c] = wp[12 * (size_t)w + c];
  const unsigned* need_row = need + (size_t)w * n_words;
  const float* cache_row = cache + (size_t)w * N;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * range;
  const int r1 = static_cast<int>(min(r0 + range, (long long)n_words));
  int* queue = squeue[warp];

  double sum[12];  // the lane's 12 sums
#pragma unroll
  for (int c = 0; c < 12; ++c) sum[c] = 0.0;
  int head = 0, count = 0;  // the same in every lane of the warp

  // The first n (<= 32) queued pairs, one per lane, through the chain.
  const auto take = [&](int n) {
    int slot = head + lane;
    slot = slot >= kQueue ? slot - kQueue : slot;
    const int i = queue[slot];
    __syncwarp();  // every lane has read its slot before a later batch is queued over it
    if (lane < n) {
      const float s = cache_row[i];
      const float px = pts[i], py = pts[(size_t)N + i], pz = pts[2 * (size_t)N + i];
      const bool ok = valid[i] > 0.0f;
      const Extras e = tile_extras(px, py, pz, wrow, cam, k);
      const float c_pn = pn_cotangent((s - m) * inv_d, g[i], hi);
      const float eqmin = (ok && s == m) ? 1.0f : 0.0f;
      const float eqmax = (ok && s == mxv) ? 1.0f : 0.0f;
      const float total = c_pn * inv_d + alpha * eqmin + beta * eqmax;
      const DcamFactors f = dcam_factors(e, cam, k);
      const float cs = total * s;
      const float dc[3] = {cs * f.bx, cs * f.by, cs * f.bz};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sum[4 * c + 0] += static_cast<double>(dc[c]);
        sum[4 * c + 1] += static_cast<double>(mul(dc[c], px));
        sum[4 * c + 2] += static_cast<double>(mul(dc[c], py));
        sum[4 * c + 3] += static_cast<double>(mul(dc[c], pz));
      }
    }
    head = head + n >= kQueue ? head + n - kQueue : head + n;
    count -= n;
  };

  constexpr int kAhead = 4;  // batches of 32 mask words whose loads are started together
  for (long long q00 = r0; q00 < r1; q00 += 32 * kAhead) {
    unsigned words[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const long long q = q00 + 32 * a + lane;
      words[a] = q < r1 ? need_row[q] : 0u;
    }
#pragma unroll 1  // one copy of the chain
    for (int a = 0; a < kAhead; ++a) {
      const unsigned word = a == 0 ? words[0] : a == 1 ? words[1] : a == 2 ? words[2] : words[3];
      if (!__any_sync(kFullWarp, word != 0u)) continue;
      // each lane's place in the queue: after the pairs of the lanes before it
      const int mine = __popc(word);
      int before = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFullWarp, before, o);
        if (lane >= o) before += v;
      }
      const int total = __shfl_sync(kFullWarp, before, 31);
      int slot = head + count + before - mine;
      slot = slot >= kQueue ? slot - kQueue : slot;
      const int first = (static_cast<int>(q00) + 32 * a + lane) * 32;
      for (unsigned bits = word; bits; bits &= bits - 1) {
        queue[slot] = first + __ffs(bits) - 1;
        slot = slot + 1 == kQueue ? 0 : slot + 1;
      }
      __syncwarp();
      count += total;
      while (count >= 32) take(32);
    }
  }
  if (count > 0) take(count);
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    double r = sum[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(kFullWarp, r, o);
    if (lane == 0) ssum[warp][c] = r;
  }
  __syncthreads();
  double* wpart = part + (size_t)w * gridDim.x * 12;
  if (tid < 12) {
    double f = 0.0;
    for (int q = 0; q < kWarps; ++q) f += ssum[q][tid];
    wpart[(size_t)blockIdx.x * 12 + tid] = f;
    __threadfence();
  }
  if (!last_to_arrive(arrivals + w, gridDim.x)) return;
  const int o = tid / kSubLanes;
  const float r = static_cast<float>(sum_parts(wpart + o, o < 12 ? gridDim.x : 0, 12));
  const bool poisoned = !(fabsf(alpha) <= kFltMax) || !(fabsf(beta) <= kFltMax);
  if (tid % kSubLanes == 0 && o < 12)
    out[(size_t)w * 12 + o] = poisoned ? __int_as_float(kNanMaxBits) : r;
  if (tid == 0) arrivals[w] = 0;
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

// The card's SM count, asked once per device (0 and an error code on failure).
int sm_count(cudaError_t* err) {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices && sms[dev] > 0) return sms[dev];
  int n = 0;
  *err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess || n <= 0) return 0;
  if (dev < kMaxDevices) sms[dev] = n;
  return n;
}

inline int mask_words(int N) { return (N + 31) / 32; }

// How many blocks of K3 the card holds at once (SMs x resident blocks of the
// kernel with fewer of them, asked once per device); 0 and an error code on
// failure.
int stats_resident(cudaError_t* err) {
  static int resident[kMaxDevices] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices && resident[dev] > 0) return resident[dev];
  const int sms = sm_count(err);
  if (sms <= 0) return 0;
  int vec = 0, scalar = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&vec, bwd_stats_kernel<true>, kThreads, 0);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&scalar, bwd_stats_kernel<false>,
                                                         kThreads, 0);
  if (*err != cudaSuccess) return 0;
  const int cap = max(1, sms * min(vec, scalar));
  if (dev < kMaxDevices) resident[dev] = cap;
  return cap;
}

// K3's grid: gridDim.y waypoint chunks; gridDim.x blocks share the point
// tiles of a chunk, as many blocks in all as the card holds at once (one
// wave, no tail), each walking the same number of tiles, give or take one.
// Few tiles: one block each.
dim3 stats_grid(int N, int W, int resident) {
  const int n_tiles = (N + kBlockPts - 1) / kBlockPts;
  const int ny = (W + kWChunk - 1) / kWChunk;
  const int nx_cap = max(1, resident / ny);
  const int rounds = (n_tiles + nx_cap - 1) / nx_cap;
  return dim3((n_tiles + rounds - 1) / rounds, ny);
}

// K4's geometry: words of mask per warp (a multiple of 32, at least 32 and
// at most 1024), sized so that the W rows give about 64 warps per SM, two
// rounds of a full card: short rows (the reference cloud) are cut into many
// small ranges so that the card is filled, long rows into ranges that
// amortise the warp's set-up and its 12 reductions. gridDim.x blocks of
// kWarps ranges per waypoint, gridDim.y = W.
struct ApplyGeom {
  int range;
  dim3 grid;
};

ApplyGeom apply_geom(int N, int W, int sms) {
  const long long words = (long long)W * mask_words(N);
  long long range = (words / (64LL * sms) + 31) / 32 * 32;
  range = range < 32 ? 32 : (range > 1024 ? 1024 : range);
  const int n_ranges = static_cast<int>((mask_words(N) + range - 1) / range);
  return ApplyGeom{static_cast<int>(range), dim3((n_ranges + kWarps - 1) / kWarps, W)};
}

inline bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

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

// K3 and K4. arrivals: at least W ints, all 0 between calls (the kernels
// restore them). part: scratch for the blocks' partial sums, part_doubles
// doubles of it; if the grid needs more, nothing is launched and the number
// needed comes back negated (a CUDA error code comes back as it is).
int fv_bwd_stats(const float* norm, const float* cache, const float* valid,
                 const float* g, int N, int W, float hi, double* part, int part_doubles,
                 int* arrivals, float* out, int* need, void* stream) {
  cudaError_t err;
  const int cap = stats_resident(&err);
  if (cap <= 0) return static_cast<int>(err);
  const dim3 grid = stats_grid(N, W, cap);
  const long long needed = 4LL * grid.x * W;
  if (needed > part_doubles) return static_cast<int>(-needed);
  const bool vec = N % 4 == 0 && aligned16(cache) && aligned16(valid) && aligned16(g);
  const auto kernel = vec ? bwd_stats_kernel<true> : bwd_stats_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      norm, cache, valid, g, N, W, hi, mask_words(N), part, arrivals, out,
      reinterpret_cast<unsigned*>(need));
  return static_cast<int>(cudaGetLastError());
}

int fv_bwd_apply(const float* wp, const float* kp, const float* norm2,
                 const float* pts, const float* valid, const float* g,
                 const float* cache, const int* need, int N, int W, float c0,
                 float inv_var, float img_w, float img_h, float eps, float inv_w,
                 float inv_h, float hi, double* part, int part_doubles, int* arrivals,
                 float* out, void* stream) {
  cudaError_t err;
  const int sms = sm_count(&err);
  if (sms <= 0) return static_cast<int>(err);
  const ApplyGeom geom = apply_geom(N, W, sms);
  const long long needed = 12LL * geom.grid.x * W;
  if (needed > part_doubles) return static_cast<int>(-needed);
  bwd_apply_kernel<<<geom.grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      wp, kp, norm2, pts, valid, g, cache, reinterpret_cast<const unsigned*>(need), N, W,
      make_consts(c0, inv_var, img_w, img_h, eps, inv_w, inv_h), hi, mask_words(N), geom.range,
      part, arrivals, out);
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
