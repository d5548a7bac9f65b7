// The trajectory loss around the visibility kernels, for Hopper (sm_90a):
// the quaternion prologue, the criterion and their hand-derived backward,
// in six kernels that leave K1-K4, K1', K2' and K5 (fused_vis.cu) as they
// are. Plain C interface, loaded with ctypes by
// trajectory_optimization_tpu_torch/ops/_kernels.py; each entry point
// launches on the caller's stream and returns cudaGetLastError(). Plain
// PyTorch versions of every kernel, with the same inputs and outputs, live
// in trajectory_optimization_tpu_torch/ops/fused_traj.py (*_ref).
//
// None of them replaces a Pallas kernel: the JAX twin leaves this work to
// XLA, which fuses it. Written as PyTorch operations it was some three
// hundred launches a step on (W, .) tensors of a few dozen rows, and in a
// captured step as many graph nodes, each costing the card about a
// microsecond whatever it computes. So what bounds this work on the card is
// its number of launches, not bytes or arithmetic: at cloud 10 (40,960
// points, 27 waypoints) traj_loss and lo_cotangent move 12-20 bytes a point
// (~0.2 us at 3.35 TB/s) and the one-block kernels a few kilobytes. The
// design is one launch per stage: traj_head, make_norm, alpha_beta and
// traj_tail are one block over the waypoints; traj_loss and lo_cotangent
// run over the points, and traj_loss finishes its partial sums, and the
// criterion's terms over the waypoints, in the last block to arrive, as K3
// and K4 do (fused_vis.cu last_to_arrive). No float atomics anywhere, so
// two runs agree bit for bit.
//
// Layout (as fused_vis.cu): poses and poses0 (W, 3), quats (W, 4) wxyz, K
// (3, 3), all f32 and contiguous; wp (W_s, 12) = [R row-major 9, t 3] for the
// W_s = ceil(W / step) scored waypoints 0, step, 2 step, ...; kp = [fx, fy,
// cx, cy]; minmax (2, W_s) = pass A's output rows; norm (W_s, 4) = [m, inv_d,
// gate, M] and norm2 (W_s, 6) adds alpha and beta; aux (8,) = [mean reward,
// loss_vis, loss_l2, loss_smooth, loss_length, the mean's denominator, the
// mean segment angle, the length difference].
//
// Built without fast-math. The forward repeats the plain version's
// operations in its order on the card, each rounded on its own (__fadd_rn
// etc., never contracted into FMAs), so R is what
// quat.to_matrix(quat.normalize(q)) gives there and K1's scores keep their
// bits; sums the plain version takes in f32
// (the mean's, the angles', the lengths') are taken in double and rounded
// once. The backward is the plain version's chain rule with FMA contraction.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPPT = 4;                     // points per thread (traj_loss)
constexpr int kBlockPts = kThreads * kPPT;  // points per block (traj_loss)
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kQuatEps = 1e-12f;    // quat.normalize's floor on the norm
constexpr float kSpanFloor = 1e-8f;   // fused_vis.SPAN_FLOOR
constexpr int kAccSlots = 40;         // K5's sums per waypoint

// The criterion's scalars (ops/fused_traj.py TrajConsts; the clamp bounds
// of numerics.acos_clipped's gradient and pi rounded to f32 by the host).
struct Crit {
  float eps, smooth_w, length_w, cos_lo, cos_hi, pi;
  int W, step;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// torch.clamp's value: NaN stays NaN (fminf/fmaxf would drop it).
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// numerics.safe_norm of a 3-vector: the sum of squares in the plain
// version's order, 0 (and a zero subgradient) at 0.
__device__ __forceinline__ float safe_norm3(float x, float y, float z) {
  const float sq = add(add(mul(x, x), mul(y, y)), mul(z, z));
  return sq == 0.0f ? 0.0f : sqrtf(sq);
}

// A sum over the block, the same in every thread: a fixed shuffle tree over
// each warp, then the warps in order. Every thread must call it.
__device__ __forceinline__ double block_sum(double x, double* sred) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullWarp, x, o);
  __syncthreads();  // sred is free: every thread has read the last sum
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = x;
  __syncthreads();
  double r = 0.0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) r += sred[q];
  return r;
}

// fused_vis.cu's last_to_arrive: every block writes its partials and fences,
// takes a ticket from the counter; the block with the last one goes on.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n_blocks) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == n_blocks - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// quat.to_matrix of a unit quaternion, operation for operation.
__device__ __forceinline__ void rotation(float w, float x, float y, float z, float* R) {
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  R[0] = sub(1.0f, mul(2.0f, add(yy, zz)));
  R[1] = mul(2.0f, sub(xy, wz));
  R[2] = mul(2.0f, add(xz, wy));
  R[3] = mul(2.0f, add(xy, wz));
  R[4] = sub(1.0f, mul(2.0f, add(xx, zz)));
  R[5] = mul(2.0f, sub(yz, wx));
  R[6] = mul(2.0f, sub(xz, wy));
  R[7] = mul(2.0f, add(yz, wx));
  R[8] = sub(1.0f, mul(2.0f, add(xx, yy)));
}

// torch.linalg.norm of a quaternion as PyTorch's CUDA reduction adds it up,
// (w^2 + y^2) + (x^2 + z^2) (on an H100 it matched that order on 100,000
// random quaternions, and none of five others), so R keeps the plain bits.
__device__ __forceinline__ float quat_norm(const float* q) {
  return sqrtf(add(add(mul(q[0], q[0]), mul(q[2], q[2])), add(mul(q[1], q[1]), mul(q[3], q[3]))));
}

// The angle at interior waypoint i (1 <= i <= W - 2), as
// ops/trajectory.mean_segment_angle and numerics.acos_clipped compute its
// value: acos(g) + (acos(v) - acos(g)), v and g the cosine clamped to
// [-1, 1] and to the gradient's window.
__device__ float angle_at(const float* p, int i, const Crit& c) {
  const float* a = p + 3 * (i - 1);
  const float* b = p + 3 * i;
  const float* d = p + 3 * (i + 1);
  const float ab0 = sub(a[0], b[0]), ab1 = sub(a[1], b[1]), ab2 = sub(a[2], b[2]);
  const float ac0 = sub(d[0], b[0]), ac1 = sub(d[1], b[1]), ac2 = sub(d[2], b[2]);
  const float dot = add(add(mul(ab0, ac0), mul(ab1, ac1)), mul(ab2, ac2));
  const float cos = dot / add(mul(safe_norm3(ab0, ab1, ab2), safe_norm3(ac0, ac1, ac2)), c.eps);
  const float ag = acosf(clampf(cos, c.cos_lo, c.cos_hi));
  return add(ag, sub(acosf(clampf(cos, -1.0f, 1.0f)), ag));
}

__device__ __forceinline__ float seg_length(const float* p, int k) {
  const float* a = p + 3 * k;
  const float* b = a + 3;
  return safe_norm3(sub(b[0], a[0]), sub(b[1], a[1]), sub(b[2], a[2]));
}

// traj_head: the prologue of the plain path on the scored waypoints,
// quats[::step] -> normalize -> R and poses[::step] into wp; kp from K; pass
// A's (2, W_s) output preset to its sentinels (big / -big, ops/_kernels.py
// BIG: what a waypoint without valid points returns), which K1 or K1' then
// merges into.
__global__ void __launch_bounds__(kThreads)
traj_head_kernel(const float* __restrict__ poses, const float* __restrict__ quats,
                 const float* __restrict__ K, int W_s, int step, float big,
                 float* __restrict__ wp, float* __restrict__ kp, float* __restrict__ minmax) {
  for (int s = threadIdx.x; s < W_s; s += kThreads) {
    const float* q = quats + 4 * (size_t)s * step;
    const float n = quat_norm(q);
    const float d = n < kQuatEps ? kQuatEps : n;  // clamp(n, min=eps); NaN stays NaN
    float R[9];
    rotation(q[0] / d, q[1] / d, q[2] / d, q[3] / d, R);
    float* o = wp + 12 * (size_t)s;
#pragma unroll
    for (int j = 0; j < 9; ++j) o[j] = R[j];
    const float* t = poses + 3 * (size_t)s * step;
    o[9] = t[0];
    o[10] = t[1];
    o[11] = t[2];
    minmax[s] = big;
    minmax[W_s + s] = -big;
  }
  if (threadIdx.x == 0) {
    kp[0] = K[0];
    kp[1] = K[4];
    kp[2] = K[2];
    kp[3] = K[5];
  }
}

// make_norm: fused_vis.make_norm, (2, W) min/max -> (W, 4) [m, 1/max(M - m,
// 1e-8), gate, M].
__global__ void __launch_bounds__(kThreads)
make_norm_kernel(const float* __restrict__ minmax, int W, float* __restrict__ norm) {
  for (int w = threadIdx.x; w < W; w += kThreads) {
    const float m = minmax[w], mx = minmax[W + w];
    const float span = sub(mx, m);
    float* o = norm + 4 * (size_t)w;
    o[0] = m;
    o[1] = 1.0f / (span < kSpanFloor ? kSpanFloor : span);
    o[2] = span > kSpanFloor ? 1.0f : 0.0f;
    o[3] = mx;
  }
}

// traj_loss: rewards = 1/(1 + exp(-lo)), each block's sums of reward * valid
// and of valid (doubles) into part, and in the last block to arrive the mean
// reward and models.traj.traj_criterion_from_mean's terms over all W: the
// anchor, the smoothness (pi below 3 waypoints), the length (|.| on the
// difference), the loss and aux. The counter is left at 0.
__global__ void __launch_bounds__(kThreads)
traj_loss_kernel(const float* __restrict__ lo, const float* __restrict__ valid,
                 const float* __restrict__ poses, const float* __restrict__ poses0, int N,
                 Crit c, double* part, int* arrival, float* __restrict__ rewards,
                 float* __restrict__ loss, float* __restrict__ aux) {
  __shared__ double sred[kWarps];
  double rv = 0.0, vv = 0.0;
  const int base = blockIdx.x * kBlockPts + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int i = base + j * kThreads;
    if (i < N) {
      const float r = 1.0f / add(1.0f, expf(-lo[i]));
      const float v = valid[i];
      rewards[i] = r;
      rv += static_cast<double>(mul(r, v));
      vv += static_cast<double>(v);
    }
  }
  rv = block_sum(rv, sred);
  vv = block_sum(vv, sred);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = rv;
    part[2 * blockIdx.x + 1] = vv;
    __threadfence();
  }
  if (!last_to_arrive(arrival, gridDim.x)) return;

  double s_rv = 0.0, s_v = 0.0, phi = 0.0, len = 0.0, len0 = 0.0;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
    s_rv += __ldcg(part + 2 * b);  // from L2: written by other blocks
    s_v += __ldcg(part + 2 * b + 1);
  }
  for (int i = threadIdx.x; i < c.W; i += kThreads) {
    if (i + 1 < c.W) {
      len += seg_length(poses, i);
      len0 += seg_length(poses0, i);
    }
    if (i >= 1 && i + 1 < c.W) phi += angle_at(poses, i, c);
  }
  s_rv = block_sum(s_rv, sred);
  s_v = block_sum(s_v, sred);
  phi = block_sum(phi, sred);
  len = block_sum(len, sred);
  len0 = block_sum(len0, sred);
  if (threadIdx.x != 0) return;
  const float v_sum = static_cast<float>(s_v);
  const float den = v_sum < 1.0f ? 1.0f : v_sum;
  const float mean = static_cast<float>(s_rv) / den;
  const float loss_vis = 1.0f / add(mean, c.eps);
  const float loss_l2 = safe_norm3(sub(poses[0], poses0[0]), sub(poses[1], poses0[1]),
                                   sub(poses[2], poses0[2]));
  const float phibar = c.W < 3 ? c.pi : static_cast<float>(phi) / static_cast<float>(c.W - 2);
  const float loss_smooth = mul(1.0f / add(phibar, c.eps), c.smooth_w);
  const float dlen = sub(static_cast<float>(len), static_cast<float>(len0));
  const float loss_length = mul(c.length_w, dlen >= 0.0f ? dlen : -dlen);
  *loss = add(add(add(loss_vis, loss_l2), loss_length), loss_smooth);
  aux[0] = mean;
  aux[1] = loss_vis;
  aux[2] = loss_l2;
  aux[3] = loss_smooth;
  aux[4] = loss_length;
  aux[5] = den;
  aux[6] = phibar;
  aux[7] = dlen;
  *arrival = 0;
}

// lo_cotangent: d loss / d lo for each point, in autograd's order through
// loss_vis = 1/(mean + eps), mean = sum(r * valid) / den and r = 1/(1 + e),
// e = exp(-lo).
__global__ void __launch_bounds__(kThreads)
lo_cotangent_kernel(const float* __restrict__ g_loss, const float* __restrict__ lo,
                    const float* __restrict__ rewards, const float* __restrict__ valid,
                    const float* __restrict__ aux, int N, float* __restrict__ g) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const float loss_vis = aux[1], den = aux[5];
  const float g_mean = -*g_loss * (loss_vis * loss_vis);
  const float g_r = (g_mean / den) * valid[i];
  const float r = rewards[i];
  const float g_x = -g_r * (r * r);
  g[i] = -(g_x * expf(-lo[i]));
}

// alpha_beta: K3's (W, 4) table -> alpha and beta, appended to norm as norm2.
__global__ void __launch_bounds__(kThreads)
alpha_beta_kernel(const float* __restrict__ stats, const float* __restrict__ norm, int W,
                  float* __restrict__ norm2) {
  for (int w = threadIdx.x; w < W; w += kThreads) {
    const float* st = stats + 4 * (size_t)w;
    float* o = norm2 + 6 * (size_t)w;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = norm[4 * (size_t)w + j];
    o[4] = st[0] / (st[2] < 1.0f ? 1.0f : st[2]);
    o[5] = st[1] / (st[3] < 1.0f ? 1.0f : st[3]);
  }
}

// The gradient that the angle at interior waypoint i sends to ab = p[i-1] -
// p[i] and ac = p[i+1] - p[i], for the cotangent g_phi of the angle:
// acos's derivative inside the clamp window of its gradient (0 outside it),
// then cos = ab.ac / (|ab| |ac| + eps) with safe_norm's zero subgradient.
__device__ void angle_grad(const float* p, int i, float g_phi, const Crit& c, float* g_ab,
                           float* g_ac) {
  const float* a = p + 3 * (i - 1);
  const float* b = p + 3 * i;
  const float* d = p + 3 * (i + 1);
  const float ab[3] = {sub(a[0], b[0]), sub(a[1], b[1]), sub(a[2], b[2])};
  const float ac[3] = {sub(d[0], b[0]), sub(d[1], b[1]), sub(d[2], b[2])};
  const float dot = add(add(mul(ab[0], ac[0]), mul(ab[1], ac[1])), mul(ab[2], ac[2]));
  const float na = safe_norm3(ab[0], ab[1], ab[2]), nc = safe_norm3(ac[0], ac[1], ac[2]);
  const float den = add(mul(na, nc), c.eps);
  const float cos = dot / den;
  const float g_cos = (cos >= c.cos_lo && cos <= c.cos_hi)
                          ? -g_phi * rsqrtf(1.0f - cos * cos) : 0.0f;
  const float g_dot = g_cos / den;
  const float g_den = -g_cos * dot / (den * den);
  const float sa = na != 0.0f ? g_den * nc / na : 0.0f;
  const float sc = nc != 0.0f ? g_den * na / nc : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_ab[k] = g_dot * ac[k] + sa * ab[k];
    g_ac[k] = g_dot * ab[k] + sc * ac[k];
  }
}

// traj_tail: the camera-plane sums of the scored waypoints (K4's (W_s, 12),
// or K5's (W_s, 40) accumulator folded as fused_vis.fused_acc_to_sums does)
// -> fused_vis.sums_to_param_grads -> to_matrix's and normalize's backward,
// written to the scored rows; plus the anchor, smoothness and length
// gradients over all W. One thread per waypoint j writes row j, gathering
// the terms of the angles at j - 1, j and j + 1 and of the segments on
// either side of it, so no row is written twice.
__global__ void __launch_bounds__(kThreads)
traj_tail_kernel(const float* __restrict__ sums, int slots, const float* __restrict__ wp,
                 const float* __restrict__ quats, const float* __restrict__ poses,
                 const float* __restrict__ poses0, const float* __restrict__ aux,
                 const float* __restrict__ g_loss, Crit c, float* __restrict__ g_poses,
                 float* __restrict__ g_quats) {
  const float gl = *g_loss;
  const float rt = 1.0f / (aux[6] + c.eps);
  const float g_phi = c.W >= 3 ? -(gl * c.smooth_w) * (rt * rt) / static_cast<float>(c.W - 2)
                               : 0.0f;
  const float g_len = gl * c.length_w * (aux[7] >= 0.0f ? 1.0f : -1.0f);
  for (int j = threadIdx.x; j < c.W; j += kThreads) {
    float gp[3] = {0.0f, 0.0f, 0.0f}, gq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (j % c.step == 0) {
      const int s = j / c.step;
      float S[12];
      if (slots == kAccSlots) {
        const float* acc = sums + kAccSlots * (size_t)s;
        const float fmin = acc[36] / (acc[38] < 1.0f ? 1.0f : acc[38]);
        const float fmax = acc[37] / (acc[39] < 1.0f ? 1.0f : acc[39]);
#pragma unroll
        for (int k = 0; k < 12; ++k) S[k] = acc[k] + acc[12 + k] * fmin + acc[24 + k] * fmax;
      } else {
#pragma unroll
        for (int k = 0; k < 12; ++k) S[k] = sums[12 * (size_t)s + k];
      }
      const float* r = wp + 12 * (size_t)s;
      // cam_c = sum_j (p_j - t_j) R_jc: dR_jc = S[c][1 + j] - t_j S[c][0],
      // dt_j = -sum_c R_jc S[c][0]
      float dR[9];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) dR[3 * a + b] = S[4 * b + 1 + a] - r[9 + a] * S[4 * b];
        gp[a] = -(r[3 * a] * S[0] + r[3 * a + 1] * S[4] + r[3 * a + 2] * S[8]);
      }
      const float* q = quats + 4 * (size_t)j;
      const float n = quat_norm(q);
      const float dn = n < kQuatEps ? kQuatEps : n;
      const float w = q[0] / dn, x = q[1] / dn, y = q[2] / dn, z = q[3] / dn;
      const float* d = dR;  // d[3 j + c] = dR_jc
      const float dq[4] = {
          2.0f * (z * (d[3] - d[1]) + y * (d[2] - d[6]) + x * (d[7] - d[5])),
          -4.0f * x * (d[4] + d[8]) + 2.0f * y * (d[1] + d[3]) + 2.0f * z * (d[2] + d[6]) +
              2.0f * w * (d[7] - d[5]),
          -4.0f * y * (d[0] + d[8]) + 2.0f * x * (d[1] + d[3]) + 2.0f * w * (d[2] - d[6]) +
              2.0f * z * (d[5] + d[7]),
          -4.0f * z * (d[0] + d[4]) + 2.0f * w * (d[3] - d[1]) + 2.0f * x * (d[2] + d[6]) +
              2.0f * y * (d[5] + d[7])};
      // q / max(|q|, eps): the floor passes no gradient, |q| has q / |q|
      const float proj = (dq[0] * q[0] + dq[1] * q[1] + dq[2] * q[2] + dq[3] * q[3]) / (dn * dn);
#pragma unroll
      for (int k = 0; k < 4; ++k) gq[k] = dq[k] / dn - proj * (n >= kQuatEps ? q[k] / n : 0.0f);
    }
    if (j == 0) {
      const float e[3] = {poses[0] - poses0[0], poses[1] - poses0[1], poses[2] - poses0[2]};
      const float nrm = safe_norm3(e[0], e[1], e[2]);
      if (nrm != 0.0f) {
#pragma unroll
        for (int k = 0; k < 3; ++k) gp[k] += gl / nrm * e[k];
      }
    }
    if (c.W >= 3) {
      float g_ab[3], g_ac[3];
      if (j >= 2) {  // the angle at j - 1: p[j] = its p[i + 1]
        angle_grad(poses, j - 1, g_phi, c, g_ab, g_ac);
#pragma unroll
        for (int k = 0; k < 3; ++k) gp[k] += g_ac[k];
      }
      if (j >= 1 && j + 1 < c.W) {  // the angle at j itself
        angle_grad(poses, j, g_phi, c, g_ab, g_ac);
#pragma unroll
        for (int k = 0; k < 3; ++k) gp[k] -= g_ab[k] + g_ac[k];
      }
      if (j + 2 < c.W) {  // the angle at j + 1: p[j] = its p[i - 1]
        angle_grad(poses, j + 1, g_phi, c, g_ab, g_ac);
#pragma unroll
        for (int k = 0; k < 3; ++k) gp[k] += g_ab[k];
      }
    }
    // segment k = p[k + 1] - p[k]: + to its end, - to its start
    for (int k = j - 1; k <= j; ++k) {
      if (k < 0 || k + 1 >= c.W) continue;
      const float* a = poses + 3 * k;
      const float sg[3] = {a[3] - a[0], a[4] - a[1], a[5] - a[2]};
      const float ns = safe_norm3(sg[0], sg[1], sg[2]);
      if (ns == 0.0f) continue;
      const float f = (k == j ? -g_len : g_len) / ns;
#pragma unroll
      for (int m = 0; m < 3; ++m) gp[m] += f * sg[m];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) g_poses[3 * (size_t)j + k] = gp[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) g_quats[4 * (size_t)j + k] = gq[k];
  }
}

inline Crit make_crit(int W, int step, float eps, float smooth_w, float length_w, float cos_lo,
                      float cos_hi, float pi) {
  return Crit{eps, smooth_w, length_w, cos_lo, cos_hi, pi, W, step};
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

int ft_traj_head(const float* poses, const float* quats, const float* K, int W_s, int step,
                 float big, float* wp, float* kp, float* minmax, void* stream) {
  traj_head_kernel<<<1, kThreads, 0, as_stream(stream)>>>(poses, quats, K, W_s, step, big, wp,
                                                         kp, minmax);
  return static_cast<int>(cudaGetLastError());
}

int ft_make_norm(const float* minmax, int W, float* norm, void* stream) {
  make_norm_kernel<<<1, kThreads, 0, as_stream(stream)>>>(minmax, W, norm);
  return static_cast<int>(cudaGetLastError());
}

// part: part_doubles doubles of scratch for the blocks' partial sums; if the
// grid needs more, nothing is launched and the number needed comes back
// negated. arrival: one int, 0 between calls (the kernel restores it).
int ft_traj_loss(const float* lo, const float* valid, const float* poses, const float* poses0,
                 int N, int W, int step, float eps, float smooth_w, float length_w,
                 float cos_lo, float cos_hi, float pi, double* part, int part_doubles,
                 int* arrival, float* rewards, float* loss, float* aux, void* stream) {
  const int blocks = (N + kBlockPts - 1) / kBlockPts;
  if (2LL * blocks > part_doubles) return -2 * blocks;
  traj_loss_kernel<<<blocks, kThreads, 0, as_stream(stream)>>>(
      lo, valid, poses, poses0, N,
      make_crit(W, step, eps, smooth_w, length_w, cos_lo, cos_hi, pi), part, arrival, rewards,
      loss, aux);
  return static_cast<int>(cudaGetLastError());
}

int ft_lo_cotangent(const float* g_loss, const float* lo, const float* rewards,
                    const float* valid, const float* aux, int N, float* g, void* stream) {
  lo_cotangent_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, as_stream(stream)>>>(
      g_loss, lo, rewards, valid, aux, N, g);
  return static_cast<int>(cudaGetLastError());
}

int ft_alpha_beta(const float* stats, const float* norm, int W, float* norm2, void* stream) {
  alpha_beta_kernel<<<1, kThreads, 0, as_stream(stream)>>>(stats, norm, W, norm2);
  return static_cast<int>(cudaGetLastError());
}

int ft_traj_tail(const float* sums, int slots, const float* wp, const float* quats,
                 const float* poses, const float* poses0, const float* aux,
                 const float* g_loss, int W, int step, float eps, float smooth_w,
                 float length_w, float cos_lo, float cos_hi, float pi, float* g_poses,
                 float* g_quats, void* stream) {
  traj_tail_kernel<<<1, kThreads, 0, as_stream(stream)>>>(
      sums, slots, wp, quats, poses, poses0, aux, g_loss,
      make_crit(W, step, eps, smooth_w, length_w, cos_lo, cos_hi, pi), g_poses, g_quats);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
