// Fused visibility log-odds kernels for Hopper (sm_90a): K1-K4 of the
// score-cache regime. Plain C interface, loaded with ctypes by
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
// Grid for K1, K3, K4: blockIdx.x over blocks of kBlockPts points (kPPT per
// thread, neighbouring threads on neighbouring points), blockIdx.y over
// chunks of kWChunk waypoints, a loop over the chunk's waypoints inside the
// block. Per-block results go to (n_blocks, W[, slots]) partials that the
// wrapper reduces with torch.amin/amax/sum: no float atomics, so a run is
// reproducible bit for bit. K2 is one thread per point looping over all W.
//
// Built WITHOUT --use_fast_math / -ftz: far points give denormal scores, and
// the min-tie count (s == m) depends on denormals surviving as they do in
// the plain version. expf, logf and '/' are the IEEE-accurate versions.
//
// All four kernels are bound by device-memory bandwidth, not arithmetic:
// at 1M points x 50 waypoints K1 writes the 200 MB cache and K2, K3 and K4
// each read it, against ~40 flops and at most 2 exp per (w, i). The design
// answers that only by touching each cache element once per kernel with
// coalesced accesses and keeping the point coordinates of a block in
// registers across its waypoint chunk; fusing passes or dropping the cache
// (16 B/point recompute) is for later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPPT = 4;                       // points per thread
constexpr int kBlockPts = kThreads * kPPT;    // points per block
constexpr int kWChunk = 8;                    // waypoints per block (K1/K3/K4)
constexpr float kBig = 3.0e38f;

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

__device__ __forceinline__ Extras tile_extras(float px, float py, float pz,
                                              const float* __restrict__ w,
                                              const Cam& cam, const Consts& k) {
  Extras e;
  const float dx = px - w[9], dy = py - w[10], dz = pz - w[11];
  const float cx = dx * w[0] + dy * w[3] + dz * w[6];
  const float cy = dx * w[1] + dy * w[4] + dz * w[7];
  const float cz = dx * w[2] + dy * w[5] + dz * w[8];
  e.ex = cx - k.c0;
  e.ey = cy - k.c0;
  e.ez = cz - k.c0;
  const float d2 = e.ex * e.ex + e.ey * e.ey + e.ez * e.ez;
  e.u = cam.fx * cx + cam.cx0 * cz;
  e.v = cam.fy * cy + cam.cy0 * cz;
  float zd = cz + k.eps;
  zd = zd >= 0.0f ? fmaxf(zd, 1e-12f) : fminf(zd, -1e-12f);
  e.inv_zd = 1.0f / zd;
  e.xu_raw = (e.u * e.inv_zd - k.img_w * 0.5f) / k.img_w;
  e.xv_raw = (e.v * e.inv_zd - k.img_h * 0.5f) / k.img_h;
  e.xu = fminf(fmaxf(e.xu_raw, -20.0f), 20.0f);
  e.xv = fminf(fmaxf(e.xv_raw, -20.0f), 20.0f);
  e.sig = 1.0f / (1.0f + expf(-cz));
  e.arg = -0.5f * (d2 * k.inv_var + e.xu * e.xu + e.xv * e.xv);
  return e;
}

__device__ __forceinline__ float clip_pn(float x, float hi) {
  return fminf(fmaxf(x, 0.5f), hi);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// K1. Replaces pallas_vis.py _minmax_cache_kernel (pass A with score cache).
// Bound by the (W, N) cache write (4 B per (w, i)) plus ~40 flops and 2 exp.
// Writes s to the cache and the block's masked min/max to (n_blocks, W)
// partials; the min/max are taken over exactly the values written.
__global__ void __launch_bounds__(kThreads)
pass_a_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
              const float* __restrict__ wp, const float* __restrict__ kp, int N,
              int W, Consts k, float* __restrict__ cache,
              float* __restrict__ pmin, float* __restrict__ pmax) {
  __shared__ float smin[kWarps][kWChunk];
  __shared__ float smax[kWarps][kWChunk];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kBlockPts;
  const int w0 = blockIdx.y * kWChunk;
  const int nw = min(kWChunk, W - w0);
  const Cam cam{kp[0], kp[1], kp[2], kp[3]};

  float px[kPPT], py[kPPT], pz[kPPT];
  bool inb[kPPT], ok[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int i = base + j * kThreads + tid;
    inb[j] = i < N;
    px[j] = inb[j] ? pts[i] : 0.0f;
    py[j] = inb[j] ? pts[(size_t)N + i] : 0.0f;
    pz[j] = inb[j] ? pts[2 * (size_t)N + i] : 0.0f;
    ok[j] = inb[j] && valid[i] > 0.0f;
  }

  for (int wl = 0; wl < nw; ++wl) {
    const int w = w0 + wl;
    const float* wrow = wp + 12 * w;
    float mn = kBig, mx = -kBig;
#pragma unroll
    for (int j = 0; j < kPPT; ++j) {
      if (!inb[j]) continue;
      const Extras e = tile_extras(px[j], py[j], pz[j], wrow, cam, k);
      const float s = e.sig * expf(e.arg);
      cache[(size_t)w * N + base + j * kThreads + tid] = s;
      if (ok[j]) {
        mn = fminf(mn, s);
        mx = fmaxf(mx, s);
      }
    }
    mn = warp_min(mn);
    mx = warp_max(mx);
    if (lane == 0) {
      smin[warp][wl] = mn;
      smax[warp][wl] = mx;
    }
  }
  __syncthreads();
  if (tid < nw) {
    float mn = kBig, mx = -kBig;
    for (int q = 0; q < kWarps; ++q) {
      mn = fminf(mn, smin[q][tid]);
      mx = fmaxf(mx, smax[q][tid]);
    }
    pmin[(size_t)blockIdx.x * W + w0 + tid] = mn;
    pmax[(size_t)blockIdx.x * W + w0 + tid] = mx;
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
      const float pn_raw = sm * inv_d;
      const bool active = pn_raw > 0.5f && pn_raw < hi;
      const float pn = clip_pn(pn_raw, hi);
      const float c_pn = active ? gg[j] / (pn * (1.0f - pn)) : 0.0f;
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
      const float sm = s - m;
      const float pn_raw = sm * inv_d;
      const bool active = pn_raw > 0.5f && pn_raw < hi;
      const float pn = clip_pn(pn_raw, hi);
      const float c_pn = active ? gg[j] / (pn * (1.0f - pn)) : 0.0f;
      const float eqmin = (ok[j] && s == m) ? 1.0f : 0.0f;
      const float eqmax = (ok[j] && s == mxv) ? 1.0f : 0.0f;
      const float total = c_pn * inv_d + alpha * eqmin + beta * eqmax;

      const float g_u = fabsf(e.xu_raw) < 20.0f ? 1.0f : 0.0f;
      const float g_v = fabsf(e.xv_raw) < 20.0f ? 1.0f : 0.0f;
      const float cs = total * s;
      const float dcx = cs * (-(e.ex * k.inv_var) - e.xu * g_u * (cam.fx * e.inv_zd * k.inv_w));
      const float dcy = cs * (-(e.ey * k.inv_var) - e.xv * g_v * (cam.fy * e.inv_zd * k.inv_h));
      const float dcz =
          cs * (-(e.ez * k.inv_var) + (1.0f - e.sig) -
                e.xu * g_u * (cam.cx0 * e.inv_zd - e.u * e.inv_zd * e.inv_zd) * k.inv_w -
                e.xv * g_v * (cam.cy0 * e.inv_zd - e.v * e.inv_zd * e.inv_zd) * k.inv_h);
      const float dc[3] = {dcx, dcy, dcz};
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

inline Consts make_consts(float c0, float inv_var, float img_w, float img_h,
                          float eps, float inv_w, float inv_h) {
  return Consts{c0, inv_var, img_w, img_h, eps, inv_w, inv_h};
}

inline dim3 chunk_grid(int N, int W) {
  return dim3((N + kBlockPts - 1) / kBlockPts, (W + kWChunk - 1) / kWChunk);
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
              float* cache, float* pmin, float* pmax, void* stream) {
  pass_a_kernel<<<chunk_grid(N, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, valid, wp, kp, N, W, make_consts(c0, inv_var, img_w, img_h, eps, inv_w, inv_h),
      cache, pmin, pmax);
  return static_cast<int>(cudaGetLastError());
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

}  // extern "C"
