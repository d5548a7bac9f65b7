// The binned soft-HPR gate's tiles, for Hopper (sm_90a): the log-sum-exp of
// every query row of every tile of one grid (soft_binned_fwd) and its
// backward (soft_binned_bwd). Plain C interface, loaded with ctypes by
// trajectory_optimization_tpu_torch/ops/_kernels.py; each entry point
// launches on the caller's stream and returns cudaGetLastError(). The plain
// PyTorch version, with the same inputs and outputs, is ops/hpr.py
// binned_lse_ref and binned_lse_bwd_ref.
//
// Neither replaces a Pallas kernel: the JAX twin leaves the tiles to XLA.
// Written as PyTorch operations, each grid built (T, cap, cap) float32
// intermediates (cos, the mask, beta*dom; in the backward exp, h, t and a)
// and ran some 30 forward and 45 backward elementwise launches over them,
// each a full pass through device memory. Here nothing of size cap^2 leaves
// the SM. What bounds the work is then the FP32 pipe and the SFU's exp:
// per pair a depth-3 dot product and a dozen operations, on no tensor core
// (a depth of 3 gains nothing there, and TF32 would move cos by far more
// than the gate's float32 rounding, see ops/hpr.py _full_f32_matmul).
//
// Layout (ops/hpr.py hpr_mask_soft_binned): U (rows, 3) directions and R
// (rows,) radii of the layout sort, with the stratified layout after them
// (rows = 2n) where cov_pos (n,) is given; bin_s (n,) int32 the sorted bin
// ids; tiles (T, 4) int64 rows (bin b, query offset, coverer offset, deep);
// beta a one-element device scalar. Query i of tile t is row qoff + i;
// coverer j is row c = coff + j, or n + c where deep. A pair counts where
// the coverer lies in bin b (bin_s[c] == b) and is not the query itself
// (cov_pos[c] where deep, else c, differs from qoff + i). Its term is
// x = (max(cos, 0) * rho_c) * beta, in the plain version's order.
//
// Two reductions leave out work whose result the gate never reads, both
// exactly:
// * a coverer outside bin b is masked in every pair, where the plain version
//   gives x = -1e30 * beta: such a term adds exp(x - top) = 0 to a row with
//   at least one pair, so each block walks only the coverers of bin b
//   (contiguous in a sorted layout; the block finds their first and last);
//   a row with no pair reads top = -1e30 * beta, total = cap, as there;
// * a query row outside bin b is never read: the gate masks it out of its
//   row maxima, so its cotangent is 0 and its terms in the backward are 0.
//   Such a row is not computed; it reads top = -1e30 * beta, total = cap in
//   both kernels, so that no inf or NaN can come of it. A block none of
//   whose rows (in the backward's column pass, coverers) lies in bin b
//   stages nothing and only writes its outputs.
//
// soft_binned_fwd: one block per (tile, block of kRows query rows; of 32,
// 64, 128 and 256, 128 was the fastest on an H100 at caps 512 and 1024).
// The block stages its tile's coverers in shared memory (u, rho, and the
// coverer's own position where it is in bin b, -1 where not: 20 bytes a
// coverer in float32, 20 KB at cap 1024), and each thread walks them for
// its query row in two passes: the max of x, then sum exp(x - max) (no
// online rescaling, so the backward's weights exp(x - top) / total are
// those of the plain version). It writes top, total and lse = top +
// log(total).
//
// soft_binned_bwd: one launch, two kinds of block (blockIdx.z). With
// t = exp(x - top) * ((beta * g) / total) on a pair and a = (t * rho_c) * h,
// h = 1, 1/2, 0 for cos >, =, < 0:
// * z = 0, row-owned, staged as the forward: each thread sums a * u_c over
//   its query row's coverers;
// * z = 1, column-owned: the block stages the tile's query rows (u, top,
//   (beta * g) / total, and the row's position where it is in bin b, -1
//   where not), and each thread sums t * max(cos, 0) and a * u_q over its
//   coverer's queries.
// The outputs are the plain version's partial sums before add_rows: (T,
// cap) for dR by coverer, (2 T cap, 3) for dU, every tile's query rows and
// then every tile's coverer rows. Each sum is one thread's loop in a fixed
// order: no atomics, so two launches agree bit for bit.
//
// Both kernels compute a pair's x by the same expression (pair_x), so the
// backward's x equals the forward's and exp(x - top) <= 1. Built without
// fast-math: expf and logf are the accurate ones. A pair whose weight
// exp(x - top) underflows to +0 adds exact zeros, and most do: x spans
// beta * rho * cos ~ 8e4 * [0.97, 1] over a bin, and e^-105 is +0, so on
// cloud 10 from path 10's waypoint 9 only 6.1% of the pairs weigh anything.
// Their exp and terms are skipped (exp_zero).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;          // query rows (or coverers) per block
constexpr double kBigSoft = 1.0e30;  // ops/hpr.py _BIG_SOFT
constexpr int kSharedDefault = 48 * 1024;

template <typename F>
struct alignas(4 * sizeof(F)) Row {
  F x, y, z, w;  // a direction and rho (coverers) or top (queries)
};

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
// a product rounded on its own, never contracted into an FMA with what
// follows: x is the plain version's rounded term in every kernel
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
// exp_(y) == +0 for every y <= exp_zero<F>(): for expf and y <= -105 (e^-105
// is 0.18 of the smallest denormal) fused_vis.cu's expf_zero_kernel proves it
// on the card for every such float; a pair whose x - top lies there adds an
// exact zero to every sum, so its exp and its terms are skipped. In double
// nothing is skipped.
template <typename F>
__device__ __forceinline__ F exp_zero();
template <>
__device__ __forceinline__ float exp_zero<float>() { return -105.0f; }
template <>
__device__ __forceinline__ double exp_zero<double>() { return -static_cast<double>(INFINITY); }

struct Tile {
  long long b, qoff, coff, deep;
};

__device__ __forceinline__ Tile load_tile(const long long* tiles, int t) {
  const long long* p = tiles + 4 * static_cast<long long>(t);
  return {p[0], p[1], p[2], p[3]};
}

// cos of a query and a coverer: the same operations in every kernel.
template <typename F>
__device__ __forceinline__ F pair_cos(F qx, F qy, F qz, const Row<F>& c) {
  return fma(qz, c.z, fma(qy, c.y, qx * c.x));
}

template <typename F>
__device__ __forceinline__ F relu(F cos) {
  return cos < F(0) ? F(0) : cos;  // torch.clamp_min: NaN stays NaN
}

// x = (max(cos, 0) * rho) * beta from max(cos, 0)
template <typename F>
__device__ __forceinline__ F pair_x(F d, F rho, F beta) {
  return mul_rn(mul_rn(d, rho), beta);
}

template <typename F>
__device__ __forceinline__ F half_step(F cos) {
  return cos > F(0) ? F(1) : (cos == F(0) ? F(0.5) : F(0));
}

// The tile's coverers into shared memory: direction and rho, and the
// coverer's own position where it lies in bin b, else -1; lo and hi the
// first and last j in bin b (lo > hi where none is).
template <typename F>
__device__ void stage_coverers(const F* __restrict__ U, const F* __restrict__ R,
                               const int* __restrict__ bin_s,
                               const long long* __restrict__ cov_pos, const Tile& t, int n,
                               int cap, Row<F>* rows, int* key, int* lo, int* hi) {
  if (threadIdx.x == 0) {
    *lo = cap;
    *hi = -1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    const long long c = t.coff + j;
    const long long crow = c + t.deep * n;
    rows[j] = {U[3 * crow], U[3 * crow + 1], U[3 * crow + 2], R[crow]};
    const bool in_bin = bin_s[c] == t.b;
    key[j] = in_bin ? static_cast<int>(t.deep && cov_pos ? cov_pos[c] : c) : -1;
    if (in_bin) {
      atomicMin(lo, j);
      atomicMax(hi, j);
    }
  }
  __syncthreads();
}

template <typename F>
__global__ void __launch_bounds__(kRows)
    soft_binned_fwd_kernel(const F* __restrict__ U, const F* __restrict__ R,
                           const F* __restrict__ beta_p, const int* __restrict__ bin_s,
                           const long long* __restrict__ cov_pos,
                           const long long* __restrict__ tiles, int n, int cap, F* top_out,
                           F* total_out, F* lse_out) {
  extern __shared__ __align__(32) unsigned char smem[];
  Row<F>* rows = reinterpret_cast<Row<F>*>(smem);
  int* key = reinterpret_cast<int*>(rows + cap);
  __shared__ int lo, hi;
  const Tile t = load_tile(tiles, blockIdx.x);
  const int i = blockIdx.y * kRows + threadIdx.x;
  const long long q = t.qoff + i;
  const bool live = i < cap && bin_s[q] == t.b;  // a row the gate reads
  const F beta = *beta_p;
  F top = static_cast<F>(-kBigSoft) * beta;  // a row with no pair
  F total = static_cast<F>(cap);
  if (__syncthreads_or(live)) {  // a block of rows outside bin b stages nothing
    stage_coverers(U, R, bin_s, cov_pos, t, n, cap, rows, key, &lo, &hi);
    if (live) {
      const F qx = U[3 * q], qy = U[3 * q + 1], qz = U[3 * q + 2];
      const int self = static_cast<int>(q);
      F m = -static_cast<F>(INFINITY);
      for (int j = lo; j <= hi; ++j) {
        const int k = key[j];
        const Row<F> c = rows[j];
        const F x = pair_x(relu(pair_cos(qx, qy, qz, c)), c.w, beta);
        if (k >= 0 && k != self && x > m) m = x;
      }
      if (m > -static_cast<F>(INFINITY)) {
        F s = F(0);
        for (int j = lo; j <= hi; ++j) {
          const int k = key[j];
          const Row<F> c = rows[j];
          const F y = pair_x(relu(pair_cos(qx, qy, qz, c)), c.w, beta) - m;
          if (k >= 0 && k != self && y > exp_zero<F>()) s += exp_(y);
        }
        top = m;
        total = s;
      }
    }
  }
  if (i >= cap) return;
  const long long o = static_cast<long long>(blockIdx.x) * cap + i;
  top_out[o] = top;
  total_out[o] = total;
  lse_out[o] = top + log_(total);
}

template <typename F>
__global__ void __launch_bounds__(kRows)
    soft_binned_bwd_kernel(const F* __restrict__ U, const F* __restrict__ R,
                           const F* __restrict__ beta_p, const int* __restrict__ bin_s,
                           const long long* __restrict__ cov_pos,
                           const long long* __restrict__ tiles, const F* __restrict__ top,
                           const F* __restrict__ total, const F* __restrict__ g, int n, int cap,
                           F* part_u, F* part_r) {
  extern __shared__ __align__(32) unsigned char smem[];
  __shared__ int lo, hi;
  const Tile t = load_tile(tiles, blockIdx.x);
  const long long T = gridDim.x;
  const long long base = static_cast<long long>(blockIdx.x) * cap;
  const F beta = *beta_p;

  if (blockIdx.z == 0) {
    // row-owned: sum over j of a * u_c for each query row
    Row<F>* rows = reinterpret_cast<Row<F>*>(smem);
    int* key = reinterpret_cast<int*>(rows + cap);
    const int i = blockIdx.y * kRows + threadIdx.x;
    const long long q = t.qoff + i;
    const bool live = i < cap && bin_s[q] == t.b;
    F ax = F(0), ay = F(0), az = F(0);
    if (__syncthreads_or(live)) {
      stage_coverers(U, R, bin_s, cov_pos, t, n, cap, rows, key, &lo, &hi);
      if (live) {
        const F qx = U[3 * q], qy = U[3 * q + 1], qz = U[3 * q + 2];
        const int self = static_cast<int>(q);
        const F m = top[base + i];
        const F w = beta * g[base + i] / total[base + i];
        for (int j = lo; j <= hi; ++j) {
          const int k = key[j];
          const Row<F> c = rows[j];
          const F cos = pair_cos(qx, qy, qz, c);
          const F y = pair_x(relu(cos), c.w, beta) - m;
          if (k >= 0 && k != self && y > exp_zero<F>()) {
            const F a = exp_(y) * w * c.w * half_step(cos);
            ax = fma(a, c.x, ax);
            ay = fma(a, c.y, ay);
            az = fma(a, c.z, az);
          }
        }
      }
    }
    if (i >= cap) return;
    F* out = part_u + 3 * (base + i);
    out[0] = ax;
    out[1] = ay;
    out[2] = az;
    return;
  }

  // column-owned: sums over i of t * max(cos, 0) and a * u_q for each coverer
  Row<F>* qrows = reinterpret_cast<Row<F>*>(smem);
  F* qw = reinterpret_cast<F*>(qrows + cap);
  int* qkey = reinterpret_cast<int*>(qw + cap);
  const int j = blockIdx.y * kRows + threadIdx.x;
  const long long c = t.coff + j;
  const bool live = j < cap && bin_s[c] == t.b;  // a coverer of bin b
  F dr = F(0), ax = F(0), ay = F(0), az = F(0);
  if (__syncthreads_or(live)) {
    if (threadIdx.x == 0) {
      lo = cap;
      hi = -1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cap; i += blockDim.x) {
      const long long q = t.qoff + i;
      const bool in_bin = bin_s[q] == t.b;
      qrows[i] = {U[3 * q], U[3 * q + 1], U[3 * q + 2], top[base + i]};
      qw[i] = in_bin ? beta * g[base + i] / total[base + i] : F(0);
      qkey[i] = in_bin ? static_cast<int>(q) : -1;
      if (in_bin) {
        atomicMin(&lo, i);
        atomicMax(&hi, i);
      }
    }
    __syncthreads();
    if (live) {
      const long long crow = c + t.deep * n;
      const Row<F> cv = {U[3 * crow], U[3 * crow + 1], U[3 * crow + 2], R[crow]};
      const int self = static_cast<int>(t.deep && cov_pos ? cov_pos[c] : c);
      for (int i = lo; i <= hi; ++i) {
        const int k = qkey[i];
        const Row<F> qv = qrows[i];
        const F cos = pair_cos(qv.x, qv.y, qv.z, cv);
        const F d = relu(cos);
        const F y = pair_x(d, cv.w, beta) - qv.w;
        if (k >= 0 && k != self && y > exp_zero<F>()) {
          const F tt = exp_(y) * qw[i];
          dr = fma(tt, d, dr);
          const F a = tt * cv.w * half_step(cos);
          ax = fma(a, qv.x, ax);
          ay = fma(a, qv.y, ay);
          az = fma(a, qv.z, az);
        }
      }
    }
  }
  if (j >= cap) return;
  part_r[base + j] = dr;
  F* out = part_u + 3 * (T * cap + base + j);
  out[0] = ax;
  out[1] = ay;
  out[2] = az;
}

template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kSharedDefault)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename F>
int launch_fwd(const void* U, const void* R, const void* beta, const int* bin_s,
               const long long* cov_pos, const long long* tiles, int n, int n_tiles, int cap,
               void* top, void* total, void* lse, cudaStream_t stream) {
  const size_t shared = static_cast<size_t>(cap) * (sizeof(Row<F>) + sizeof(int));
  cudaError_t err = allow_shared(soft_binned_fwd_kernel<F>, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, (cap + kRows - 1) / kRows);
  soft_binned_fwd_kernel<F><<<grid, kRows, shared, stream>>>(
      static_cast<const F*>(U), static_cast<const F*>(R), static_cast<const F*>(beta), bin_s,
      cov_pos, tiles, n, cap, static_cast<F*>(top), static_cast<F*>(total),
      static_cast<F*>(lse));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_bwd(const void* U, const void* R, const void* beta, const int* bin_s,
               const long long* cov_pos, const long long* tiles, const void* top,
               const void* total, const void* g, int n, int n_tiles, int cap, void* part_u,
               void* part_r, cudaStream_t stream) {
  const size_t rows = sizeof(Row<F>) + sizeof(int);
  const size_t cols = sizeof(Row<F>) + sizeof(F) + sizeof(int);
  const size_t shared = static_cast<size_t>(cap) * (rows > cols ? rows : cols);
  cudaError_t err = allow_shared(soft_binned_bwd_kernel<F>, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, (cap + kRows - 1) / kRows, 2);
  soft_binned_bwd_kernel<F><<<grid, kRows, shared, stream>>>(
      static_cast<const F*>(U), static_cast<const F*>(R), static_cast<const F*>(beta), bin_s,
      cov_pos, tiles, static_cast<const F*>(top), static_cast<const F*>(total),
      static_cast<const F*>(g), n, cap, static_cast<F*>(part_u), static_cast<F*>(part_r));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// double_precision: 0 for float32 tensors, 1 for float64.
int sb_fwd(int double_precision, const void* U, const void* R, const void* beta,
           const int* bin_s, const long long* cov_pos, const long long* tiles, int n,
           int n_tiles, int cap, void* top, void* total, void* lse, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return double_precision
             ? launch_fwd<double>(U, R, beta, bin_s, cov_pos, tiles, n, n_tiles, cap, top,
                                  total, lse, s)
             : launch_fwd<float>(U, R, beta, bin_s, cov_pos, tiles, n, n_tiles, cap, top,
                                 total, lse, s);
}

int sb_bwd(int double_precision, const void* U, const void* R, const void* beta,
           const int* bin_s, const long long* cov_pos, const long long* tiles, const void* top,
           const void* total, const void* g, int n, int n_tiles, int cap, void* part_u,
           void* part_r, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return double_precision
             ? launch_bwd<double>(U, R, beta, bin_s, cov_pos, tiles, top, total, g, n, n_tiles,
                                  cap, part_u, part_r, s)
             : launch_bwd<float>(U, R, beta, bin_s, cov_pos, tiles, top, total, g, n, n_tiles,
                                 cap, part_u, part_r, s);
}

}  // extern "C"
