// The binned soft-HPR gate's layout, for Hopper (sm_90a): routing, the
// layouts of the four grids, their tile tables and row maxima, and the
// backward that maps the tiles' partial sums back to the points. Plain C
// interface, loaded with ctypes by trajectory_optimization_tpu_torch/ops/
// _kernels.py; each entry point launches on the caller's stream and returns
// cudaGetLastError(). The plain PyTorch version, with the same results, is
// ops/hpr.py's per-grid chain (_grid_bin_key, _plain_grid_layout, the row
// maxima of hpr_mask_soft_binned, add_rows), which the CPU runs.
//
// Replaces no TPU kernel: the JAX twin leaves the layout to XLA. Written as
// PyTorch operations, each grid of each gate call ran some 175 small
// launches forward and 125 backward (the key's elementwise chain, two sorts
// each followed by five gathers, a searchsorted, a serial cummax for the
// rank in a bin, the tile table, the row maxima's where/scatter_reduce/
// index_copy/maximum, and in the backward the gathers' transposes and two
// index_put_ that sort the row indices again). At 40,960 points that work
// moves a few MB: launches, not bytes, bound it. Here the four grids run
// together, in four kernels forward around one stable sort and three
// backward (besides the tiles' own, csrc/soft_binned.cu):
//
// * bl_keys: one thread a point computes its routing angles from its unit
//   direction, as ops/hpr.py _direction_angles does (the same asin and atan2
//   of the CUDA math library), and the int32 (bin, distance) sort key of
//   every grid with the plain chain's float operations in its order
//   (__fdiv_rn/__fmul_rn/__fadd_rn: no reciprocal, no FMA contraction), so
//   the keys are those of _grid_bin_key bit for bit. Grid g's keys, all in
//   [0, 2^30), are shifted by (g - 2) 2^30, so one stable sort of the 4N
//   keys orders grid by grid, each by its key and then by point: the plain
//   chain's permutation, ties included.
// * bl_layout: one thread a sorted row of a grid: its bin, the bin edges
//   (searchsorted's) from run boundaries, the rank in the bin from the bin's
//   first row (a binary search over the sorted keys, no cummax), and the
//   row's place in the stratified layout in closed form: the second sort of
//   the plain chain orders each bin by priority, the selected ranks first in
//   rank order and then the rest in rank order, and the count of selected
//   ranks below r is a sum over the four tiers. It gathers u and rho into
//   both layouts' rows of the grid's U/R table.
// * bl_tables: one block a grid: the scan of ceil(count / cap) over the bins
//   and the static tile table (bin, query offset, coverer offset, deep) with
//   its mask of real tiles, in the plain chain's int64 arithmetic.
// * bl_rowmax: one thread a point: each grid's row maximum of lse / beta over
//   the real tiles whose query rows hold it (the tiles of its bin, found by a
//   binary search over the table's sorted bins), and their maximum over the
//   grids; no atomics, no scatter.
// * bl_rowmax_bwd: one thread an entry of a grid's (T, cap) lse: the
//   cotangent the plain chain gives it, with its tie rules: torch.maximum's
//   halves along the chain of grids, and scatter_reduce("amax")'s even split
//   among the entries equal to the row's maximum.
// * bl_rows: one thread a row of one grid's U/R table (the backward of
//   ops/hpr.py _BinnedLSE): the tiles' partial sums that belong to it, found
//   from the table (the tiles of its bin), added in a fixed order: every
//   query partial in tile order, then every coverer partial in tile order.
//   No sort of row indices, no atomics: two calls agree bit for bit.
// * bl_layout_bwd: one thread a point: its rows of every grid's table, both
//   layouts, added in a fixed order into du (N, 3) and drho (N).
//
// A row whose maximum is the -1e30 floor has no pair in any tile that holds
// it, so its terms in the backward are zero whatever its cotangent: such
// rows take a zero cotangent here (the plain chain hands them a share of
// one), with the same gradient.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kGrids = 4;
constexpr int kThreads = 256;
constexpr int kTableThreads = 1024;
constexpr long long kGridSpan = 1LL << 30;  // a grid's keys lie in [0, 2^30)
constexpr double kBigSoft = 1.0e30;          // ops/hpr.py _BIG_SOFT
constexpr double kPi = 3.141592653589793;       // np.pi
constexpr double kHalfPi = 1.5707963267948966;  // np.pi / 2
constexpr double kTwoPi = 6.283185307179586;    // 2.0 * np.pi

// One grid of ops/hpr.py _binned_grids, as ops/_kernels.py lays it out.
struct GridSpec {
  int n_rings, n_bins, frac_bits, strat;  // strat: the stratified layout is built
  int table;                              // n_az, then the ring offsets, in the int table
  int tiles, n_tiles;                     // the grid's first slot and slots in the table
  float delta, lat_shift, az_shift;
};

struct Grids {
  GridSpec g[kGrids];
};

template <typename F>
struct Ptr4 {
  F* p[kGrids];
};

// The plain chain's float operations, each rounded on its own.
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float asin_(float x) { return asinf(x); }
__device__ __forceinline__ double asin_(double x) { return asin(x); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }

// torch.clamp(x, lo, hi): NaN stays NaN
template <typename F>
__device__ __forceinline__ F clamp_(F x, F lo, F hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.maximum: NaN wins
template <typename F>
__device__ __forceinline__ F maximum_(F a, F b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// the first x in [lo, hi) with at(x) >= v (at nondecreasing)
template <typename At>
__device__ __forceinline__ int lower_bound(int lo, int hi, long long v, At at) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (at(mid) < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the first x in [lo, hi) with at(x) > v
template <typename At>
__device__ __forceinline__ int upper_bound(int lo, int hi, long long v, At at) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (at(mid) <= v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ops/hpr.py _stratified_priority's selection: every rank below base, then
// in tier k = 0..3 (ranks [base 2^k, base 2^(k+1))) the multiples of 2^(k+1)
__device__ __forceinline__ bool selected(long long r, long long base) {
  if (r < base) return true;
  if (r >= 16 * base) return false;
  int k = 0;
  while (k < 3 && r >= (base << (k + 1))) ++k;
  return (r & ((2LL << k) - 1)) == 0;
}

// the selected ranks below r
__device__ __forceinline__ long long selected_below(long long r, long long base) {
  long long c = r < base ? r : base;
  for (int k = 0; k < 4; ++k) {
    const long long lo = base << k, hi = base << (k + 1), m = 2LL << k;
    const long long top = r < hi ? r : hi;
    if (top > lo) c += (top + m - 1) / m - (lo + m - 1) / m;
  }
  return c;
}

struct Tile {
  long long b, qoff, coff, deep;
};

__device__ __forceinline__ Tile load_tile(const long long* tiles, long long t) {
  const long long* p = tiles + 4 * t;
  return {p[0], p[1], p[2], p[3]};
}

// the first of the n_tiles slots of a grid's table whose bin is b (the
// table's bins are sorted: the real tiles bin by bin, then the empty slots
// under the last bin)
__device__ __forceinline__ int first_tile(const long long* tiles, int n_tiles, long long b) {
  return lower_bound(0, n_tiles, b, [&](int t) { return tiles[4 * static_cast<long long>(t)]; });
}

// ---- keys -----------------------------------------------------------------

template <typename F>
__global__ void __launch_bounds__(kThreads)
    keys_kernel(const F* __restrict__ u, const F* __restrict__ norms,
                const F* __restrict__ scale_p, const bool* __restrict__ valid,
                const int* __restrict__ table, Grids gs, int n, int* __restrict__ keys) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  // lat = asin(clamp(u_z, -1, 1)), az = atan2(u_y, u_x) + pi
  const F* d = u + 3LL * p;
  const F la = asin_(clamp_(d[2], F(-1), F(1)));
  const F a = add_rn(atan2_(d[1], d[0]), static_cast<F>(kPi));
  // frac = clamp(norms / clamp(scale, min=1e-12), 0, 1 - 1e-6)
  F sc = *scale_p;
  if (sc < static_cast<F>(1e-12)) sc = static_cast<F>(1e-12);
  const F frac = clamp_(div_rn(norms[p], sc), F(0), static_cast<F>(1.0 - 1e-6));
  const F lat_c = add_rn(la, static_cast<F>(kHalfPi));
  const F az_c = div_rn(a, static_cast<F>(static_cast<float>(kTwoPi)));
#pragma unroll
  for (int g = 0; g < kGrids; ++g) {
    const GridSpec& s = gs.g[g];
    int ring = static_cast<int>(
        floor_(add_rn(div_rn(lat_c, static_cast<F>(s.delta)), static_cast<F>(s.lat_shift))));
    ring = ring < 0 ? 0 : (ring > s.n_rings - 1 ? s.n_rings - 1 : ring);
    const int cells = table[s.table + ring];
    int azbin = static_cast<int>(
        floor_(add_rn(mul_rn(az_c, static_cast<F>(cells)), static_cast<F>(s.az_shift))));
    if (azbin >= cells) azbin -= cells;  // wrap
    int bin = table[s.table + s.n_rings + ring] + azbin;
    if (valid && !valid[p]) bin = s.n_bins;  // padding -> the overflow bin
    const int fi = static_cast<int>(mul_rn(frac, static_cast<F>(1 << s.frac_bits)));
    const long long key = static_cast<long long>(bin) * (1LL << s.frac_bits) + fi;
    keys[static_cast<long long>(g) * n + p] = static_cast<int>(key + (g - 2) * kGridSpan);
  }
}

// ---- layouts ----------------------------------------------------------------

template <typename F>
__global__ void __launch_bounds__(kThreads)
    layout_kernel(const int* __restrict__ keys_s, const long long* __restrict__ order,
                  const F* __restrict__ u, const F* __restrict__ rho, Grids gs, int n, int cap,
                  int n_edges, Ptr4<F> U, Ptr4<F> R, int* __restrict__ bin_s,
                  int* __restrict__ edges, long long* __restrict__ cov_pos,
                  int* __restrict__ perm, int* __restrict__ pos_a, int* __restrict__ pos_b) {
  const int g = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const GridSpec& sp = gs.g[g];
  const long long base = static_cast<long long>(g) * n;
  const long long shift = (g - 2) * kGridSpan;
  const int fb = sp.frac_bits;
  auto bin_at = [&](int x) {
    return (static_cast<long long>(keys_s[base + x]) - shift) >> fb;
  };
  const long long b = bin_at(s);
  const int p = static_cast<int>(order[base + s] - base);
  bin_s[base + s] = static_cast<int>(b);
  perm[base + s] = p;
  pos_a[base + p] = s;
  // searchsorted(bin_s, arange(n_bins + 1)): edge k is the first row whose
  // bin is >= k, written by the row that starts the run reaching past it
  int* e = edges + static_cast<long long>(g) * n_edges;
  const long long prev = s > 0 ? bin_at(s - 1) : -1;
  for (long long k = prev + 1; k <= b; ++k) e[k] = s;
  if (s == n - 1)
    for (long long k = b + 1; k <= sp.n_bins; ++k) e[k] = n;
  F* Ug = U.p[g];
  F* Rg = R.p[g];
  const F ux = u[3LL * p], uy = u[3LL * p + 1], uz = u[3LL * p + 2], r = rho[p];
  Ug[3LL * s] = ux;
  Ug[3LL * s + 1] = uy;
  Ug[3LL * s + 2] = uz;
  Rg[s] = r;
  if (!sp.strat) return;
  // the stratified layout (rows n..2n): each bin by priority, the selected
  // ranks first
  const int start = lower_bound(0, s, b, bin_at);
  const int end = upper_bound(s + 1, n, b, bin_at);
  const long long base_rank = cap / 4 > 1 ? cap / 4 : 1;
  const long long rank = s - start;
  const long long below = selected_below(rank, base_rank);
  const long long at = selected(rank, base_rank)
                           ? below
                           : selected_below(end - start, base_rank) + (rank - below);
  const int s2 = start + static_cast<int>(at);
  cov_pos[base + s2] = s;
  pos_b[base + p] = s2;
  const long long row = static_cast<long long>(n) + s2;
  Ug[3 * row] = ux;
  Ug[3 * row + 1] = uy;
  Ug[3 * row + 2] = uz;
  Rg[row] = r;
}

// ---- tile tables ------------------------------------------------------------

__global__ void __launch_bounds__(kTableThreads)
    tables_kernel(const int* __restrict__ edges, Grids gs, int n, int cap, int n_edges,
                  int* __restrict__ cum_all, long long* __restrict__ tiles,
                  bool* __restrict__ tile_ok) {
  __shared__ int sums[kTableThreads];
  const int g = blockIdx.x;
  const GridSpec& sp = gs.g[g];
  const int* e = edges + static_cast<long long>(g) * n_edges;
  int* cum = cum_all + static_cast<long long>(g) * n_edges;
  const int nb = sp.n_bins;
  auto tiles_of = [&](int b) { return (e[b + 1] - e[b] + cap - 1) / cap; };
  // exclusive scan of the bins' tile counts: a run of bins per thread
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int b0 = threadIdx.x * per;
  const int b1 = b0 + per < nb ? b0 + per : nb;
  int own = 0;
  for (int b = b0; b < b1; ++b) own += tiles_of(b);
  sums[threadIdx.x] = own;
  __syncthreads();
  for (int d = 1; d < blockDim.x; d <<= 1) {
    const int v = threadIdx.x >= d ? sums[threadIdx.x - d] : 0;
    __syncthreads();
    sums[threadIdx.x] += v;
    __syncthreads();
  }
  int run = sums[threadIdx.x] - own;
  for (int b = b0; b < b1; ++b) {
    cum[b] = run;
    run += tiles_of(b);
  }
  if (threadIdx.x == blockDim.x - 1) cum[nb] = sums[threadIdx.x];
  __syncthreads();
  // the static slots: tile_bin = clamp(searchsorted(cum, slot, right) - 1)
  const long long top = n - cap;
  for (int t = threadIdx.x; t < sp.n_tiles; t += blockDim.x) {
    int tb = upper_bound(0, nb + 1, t, [&](int x) { return static_cast<long long>(cum[x]); }) - 1;
    tb = tb < 0 ? 0 : (tb > nb - 1 ? nb - 1 : tb);
    const long long within = t - cum[tb];
    const long long start = e[tb];
    long long qoff = start + within * cap;
    qoff = qoff < 0 ? 0 : (qoff > top ? top : qoff);
    const long long coff = start < 0 ? 0 : (start > top ? top : start);
    long long* out = tiles + 4LL * (sp.tiles + t);
    out[0] = tb;
    out[1] = qoff;
    out[2] = coff;
    out[3] = sp.strat && within >= 1 ? 1 : 0;
    tile_ok[sp.tiles + t] = within < tiles_of(tb);
  }
}

// ---- row maxima -------------------------------------------------------------

// Grid g's row maximum of lse / beta at sorted row s of bin b: over the real
// tiles of b whose query rows hold s, from the -1e30 floor
// (scatter_reduce("amax", include_self=True): NaN wins).
template <typename F>
__device__ __forceinline__ F grid_max(const F* __restrict__ lse, const long long* __restrict__ tiles,
                                      const bool* __restrict__ ok, int n_tiles, int cap, F beta,
                                      long long b, long long s) {
  F v = static_cast<F>(-kBigSoft);
  for (int t = first_tile(tiles, n_tiles, b); t < n_tiles; ++t) {
    const Tile tl = load_tile(tiles, t);
    if (tl.b != b || !ok[t]) break;  // the empty slots follow the real ones
    const long long i = s - tl.qoff;
    if (i < 0 || i >= cap) continue;
    const F x = div_rn(lse[t * static_cast<long long>(cap) + i], beta);
    if (x != x || v < x) v = x;
  }
  return v;
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    rowmax_kernel(Ptr4<const F> lse, const F* __restrict__ beta_p, const int* __restrict__ bin_s,
                  const int* __restrict__ pos_a, const long long* __restrict__ tiles,
                  const bool* __restrict__ tile_ok, Grids gs, int n, int cap, F* __restrict__ up,
                  F* __restrict__ smax) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const F beta = *beta_p;
  F m = static_cast<F>(-kBigSoft);
#pragma unroll
  for (int g = 0; g < kGrids; ++g) {
    const GridSpec& sp = gs.g[g];
    const long long base = static_cast<long long>(g) * n;
    const int s = pos_a[base + p];
    const F v = grid_max(lse.p[g], tiles + 4LL * sp.tiles, tile_ok + sp.tiles, sp.n_tiles, cap,
                         beta, bin_s[base + s], s);
    up[base + p] = v;
    m = maximum_(m, v);
  }
  smax[p] = m;
}

// The cotangent of grid g's row maximum in smax = maximum(...maximum(
// maximum(-1e30, up_0), up_1)..., up_3) for smax's cotangent gs: at each
// step torch.maximum halves it at a tie, else hands it to the larger side.
template <typename F>
__device__ __forceinline__ F chain_grad(const F* up, F gs, int grid) {
  F pre[kGrids + 1];
  pre[0] = static_cast<F>(-kBigSoft);
#pragma unroll
  for (int k = 0; k < kGrids; ++k) pre[k + 1] = maximum_(pre[k], up[k]);
  F G = gs;
  for (int k = kGrids - 1; k >= 0; --k) {
    const F a = pre[k], b = up[k];
    F self, other;
    if (a == b) {
      self = other = G / F(2);
    } else if (a < b) {
      self = F(0);
      other = G;
    } else if (a > b) {
      self = G;
      other = F(0);
    } else {  // NaN: both take it
      self = other = G;
    }
    if (k == grid) return other;
    G = self;
  }
  return F(0);
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    rowmax_bwd_kernel(const F* __restrict__ g_smax, Ptr4<const F> lse,
                      const F* __restrict__ beta_p, const int* __restrict__ bin_s,
                      const int* __restrict__ perm, const F* __restrict__ up,
                      const long long* __restrict__ tiles, const bool* __restrict__ tile_ok,
                      Grids gs, int n, int cap, F* __restrict__ g_lse) {
  const int g = blockIdx.y;
  const GridSpec& sp = gs.g[g];
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long rows = static_cast<long long>(sp.n_tiles) * cap;
  if (e >= rows) return;
  F* out = g_lse + static_cast<long long>(sp.tiles) * cap + e;
  const int t = static_cast<int>(e / cap);
  const long long* gt = tiles + 4LL * sp.tiles;
  const Tile tl = load_tile(gt, t);
  const long long base = static_cast<long long>(g) * n;
  const long long q = tl.qoff + e % cap;
  if (!tile_ok[sp.tiles + t] || bin_s[base + q] != tl.b) {
    *out = F(0);  // masked out of the maximum
    return;
  }
  const F beta = *beta_p;
  const int p = perm[base + q];
  F u4[kGrids];
#pragma unroll
  for (int k = 0; k < kGrids; ++k) u4[k] = up[static_cast<long long>(k) * n + p];
  const F value = u4[g];
  const F x = div_rn(lse.p[g][e], beta);
  if (!(value > static_cast<F>(-kBigSoft)) || !(x == value)) {
    *out = F(0);
    return;
  }
  // the entries equal to the row's maximum share its cotangent evenly
  int count = 0;
  for (int k = first_tile(gt, sp.n_tiles, tl.b); k < sp.n_tiles; ++k) {
    const Tile o = load_tile(gt, k);
    if (o.b != tl.b || !tile_ok[sp.tiles + k]) break;
    const long long i = q - o.qoff;
    if (i >= 0 && i < cap && div_rn(lse.p[g][k * static_cast<long long>(cap) + i], beta) == value)
      ++count;
  }
  *out = div_rn(div_rn(chain_grad(u4, g_smax[p], g), static_cast<F>(count)), beta);
}

// ---- the tiles' partial sums back to the rows ---------------------------------

template <typename F>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const F* __restrict__ part_u, const F* __restrict__ part_r,
                const int* __restrict__ bin_s, const long long* __restrict__ tiles, int n,
                int n_tiles, int cap, int rows, F* __restrict__ dU, F* __restrict__ dR) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const bool deep_row = r >= n;  // a row of the stratified layout
  const long long s = deep_row ? r - n : r;
  const long long b = bin_s[s];  // a bin keeps its rows in both layouts
  const long long cols = static_cast<long long>(n_tiles) * cap;
  const int t0 = first_tile(tiles, n_tiles, b);
  F ux = F(0), uy = F(0), uz = F(0), dr = F(0);
  if (!deep_row) {
    for (int t = t0; t < n_tiles; ++t) {
      const Tile tl = load_tile(tiles, t);
      if (tl.b != b) break;
      const long long i = s - tl.qoff;
      if (i < 0 || i >= cap) continue;
      const F* v = part_u + 3 * (t * static_cast<long long>(cap) + i);
      ux += v[0];
      uy += v[1];
      uz += v[2];
    }
  }
  for (int t = t0; t < n_tiles; ++t) {
    const Tile tl = load_tile(tiles, t);
    if (tl.b != b) break;
    if ((tl.deep != 0) != deep_row) continue;
    const long long j = s - tl.coff;
    if (j < 0 || j >= cap) continue;
    const long long c = t * static_cast<long long>(cap) + j;
    const F* v = part_u + 3 * (cols + c);
    ux += v[0];
    uy += v[1];
    uz += v[2];
    dr += part_r[c];
  }
  dU[3LL * r] = ux;
  dU[3LL * r + 1] = uy;
  dU[3LL * r + 2] = uz;
  dR[r] = dr;
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    layout_bwd_kernel(Ptr4<const F> dU, Ptr4<const F> dR, const int* __restrict__ pos_a,
                      const int* __restrict__ pos_b, Grids gs, int n, F* __restrict__ du,
                      F* __restrict__ drho) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  F ux = F(0), uy = F(0), uz = F(0), dr = F(0);
#pragma unroll
  for (int g = 0; g < kGrids; ++g) {
    const long long base = static_cast<long long>(g) * n;
    long long rows[2] = {pos_a[base + p], -1};
    if (gs.g[g].strat) rows[1] = static_cast<long long>(n) + pos_b[base + p];
    for (int k = 0; k < 2; ++k) {
      const long long r = rows[k];
      if (r < 0) continue;
      if (dU.p[g]) {
        ux += dU.p[g][3 * r];
        uy += dU.p[g][3 * r + 1];
        uz += dU.p[g][3 * r + 2];
      }
      if (dR.p[g]) dr += dR.p[g][r];
    }
  }
  du[3LL * p] = ux;
  du[3LL * p + 1] = uy;
  du[3LL * p + 2] = uz;
  drho[p] = dr;
}

Grids load_grids(const void* specs) {
  Grids gs;
  memcpy(&gs, specs, sizeof(gs));
  return gs;
}

unsigned blocks(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

template <typename F>
Ptr4<F> ptr4(void* const* p) {
  Ptr4<F> out;
  for (int g = 0; g < kGrids; ++g) out.p[g] = static_cast<F*>(p[g]);
  return out;
}

int max_tiles(const Grids& gs) {
  int m = 0;
  for (int g = 0; g < kGrids; ++g) m = gs.g[g].n_tiles > m ? gs.g[g].n_tiles : m;
  return m;
}

template <typename F>
int keys(const void* u, const void* norms, const void* scale, const bool* valid,
         const int* table, const Grids& gs, int n, int* out, cudaStream_t s) {
  keys_kernel<F><<<blocks(n), kThreads, 0, s>>>(
      static_cast<const F*>(u), static_cast<const F*>(norms), static_cast<const F*>(scale),
      valid, table, gs, n, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int layout(const int* keys_s, const long long* order, const void* u, const void* rho,
           const Grids& gs, int n, int cap, int n_edges, void* const* U, void* const* R,
           int* bin_s, int* edges, long long* cov_pos, int* perm, int* pos_a, int* pos_b,
           cudaStream_t s) {
  const dim3 grid(blocks(n), kGrids);
  layout_kernel<F><<<grid, kThreads, 0, s>>>(
      keys_s, order, static_cast<const F*>(u), static_cast<const F*>(rho), gs, n, cap, n_edges,
      ptr4<F>(U), ptr4<F>(R), bin_s, edges, cov_pos, perm, pos_a, pos_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int rowmax(void* const* lse, const void* beta, const int* bin_s, const int* pos_a,
           const long long* tiles, const bool* ok, const Grids& gs, int n, int cap, void* up,
           void* smax, cudaStream_t s) {
  rowmax_kernel<F><<<blocks(n), kThreads, 0, s>>>(
      ptr4<const F>(lse), static_cast<const F*>(beta), bin_s, pos_a, tiles, ok, gs, n, cap,
      static_cast<F*>(up), static_cast<F*>(smax));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int rowmax_bwd(const void* g_smax, void* const* lse, const void* beta, const int* bin_s,
               const int* perm, const void* up, const long long* tiles, const bool* ok,
               const Grids& gs, int n, int cap, void* g_lse, cudaStream_t s) {
  const dim3 grid(blocks(static_cast<long long>(max_tiles(gs)) * cap), kGrids);
  rowmax_bwd_kernel<F><<<grid, kThreads, 0, s>>>(
      static_cast<const F*>(g_smax), ptr4<const F>(lse), static_cast<const F*>(beta), bin_s,
      perm, static_cast<const F*>(up), tiles, ok, gs, n, cap, static_cast<F*>(g_lse));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int rows(const void* part_u, const void* part_r, const int* bin_s, const long long* tiles,
         int n, int n_tiles, int cap, int n_rows, void* dU, void* dR, cudaStream_t s) {
  rows_kernel<F><<<blocks(n_rows), kThreads, 0, s>>>(
      static_cast<const F*>(part_u), static_cast<const F*>(part_r), bin_s, tiles, n, n_tiles,
      cap, n_rows, static_cast<F*>(dU), static_cast<F*>(dR));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int layout_bwd(void* const* dU, void* const* dR, const int* pos_a, const int* pos_b,
               const Grids& gs, int n, void* du, void* drho, cudaStream_t s) {
  layout_bwd_kernel<F><<<blocks(n), kThreads, 0, s>>>(
      ptr4<const F>(dU), ptr4<const F>(dR), pos_a, pos_b, gs, n, static_cast<F*>(du),
      static_cast<F*>(drho));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry point: double_precision 0 for float32 tensors, 1 for float64;
// specs the host address of the four GridSpecs; the pointer arrays (U, R,
// lse, dU, dR) four device addresses on the host.

int bl_keys(int double_precision, const void* u, const void* norms, const void* scale,
            const bool* valid, const int* table, const void* specs, int n, int* out,
            void* stream) {
  const Grids gs = load_grids(specs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return double_precision ? keys<double>(u, norms, scale, valid, table, gs, n, out, s)
                          : keys<float>(u, norms, scale, valid, table, gs, n, out, s);
}

int bl_layout(int double_precision, const int* keys_s, const long long* order, const void* u,
              const void* rho, const void* specs, int n, int cap, int n_edges, void* const* U,
              void* const* R, int* bin_s, int* edges, long long* cov_pos, int* perm, int* pos_a,
              int* pos_b, void* stream) {
  const Grids gs = load_grids(specs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return double_precision
             ? layout<double>(keys_s, order, u, rho, gs, n, cap, n_edges, U, R, bin_s, edges,
                              cov_pos, perm, pos_a, pos_b, s)
             : layout<float>(keys_s, order, u, rho, gs, n, cap, n_edges, U, R, bin_s, edges,
                             cov_pos, perm, pos_a, pos_b, s);
}

int bl_tables(const int* edges, const void* specs, int n, int cap, int n_edges, int* cum,
              long long* tiles, bool* tile_ok, void* stream) {
  const Grids gs = load_grids(specs);
  tables_kernel<<<kGrids, kTableThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      edges, gs, n, cap, n_edges, cum, tiles, tile_ok);
  return static_cast<int>(cudaGetLastError());
}

int bl_rowmax(int double_precision, void* const* lse, const void* beta, const int* bin_s,
              const int* pos_a, const long long* tiles, const bool* tile_ok, const void* specs,
              int n, int cap, void* up, void* smax, void* stream) {
  const Grids gs = load_grids(specs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return double_precision
             ? rowmax<double>(lse, beta, bin_s, pos_a, tiles, tile_ok, gs, n, cap, up, smax, s)
             : rowmax<float>(lse, beta, bin_s, pos_a, tiles, tile_ok, gs, n, cap, up, smax, s);
}

int bl_rowmax_bwd(int double_precision, const void* g_smax, void* const* lse, const void* beta,
                  const int* bin_s, const int* perm, const void* up, const long long* tiles,
                  const bool* tile_ok, const void* specs, int n, int cap, void* g_lse,
                  void* stream) {
  const Grids gs = load_grids(specs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return double_precision ? rowmax_bwd<double>(g_smax, lse, beta, bin_s, perm, up, tiles,
                                               tile_ok, gs, n, cap, g_lse, s)
                          : rowmax_bwd<float>(g_smax, lse, beta, bin_s, perm, up, tiles,
                                              tile_ok, gs, n, cap, g_lse, s);
}

int bl_rows(int double_precision, const void* part_u, const void* part_r, const int* bin_s,
            const long long* tiles, int n, int n_tiles, int cap, int n_rows, void* dU, void* dR,
            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return double_precision
             ? rows<double>(part_u, part_r, bin_s, tiles, n, n_tiles, cap, n_rows, dU, dR, s)
             : rows<float>(part_u, part_r, bin_s, tiles, n, n_tiles, cap, n_rows, dU, dR, s);
}

int bl_layout_bwd(int double_precision, void* const* dU, void* const* dR, const int* pos_a,
                  const int* pos_b, const void* specs, int n, void* du, void* drho,
                  void* stream) {
  const Grids gs = load_grids(specs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return double_precision ? layout_bwd<double>(dU, dR, pos_a, pos_b, gs, n, du, drho, s)
                          : layout_bwd<float>(dU, dR, pos_a, pos_b, gs, n, du, drho, s);
}

}  // extern "C"
