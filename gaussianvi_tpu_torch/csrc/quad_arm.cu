// The sigma-point quadrature kernel (K3) at the 7-DOF arm's shapes: local
// dim D = 14 ([theta; theta_dot]), the cost ArmSdfCost (costs.cuh: DH
// forward kinematics, seven spheres, the 3-D field) on the joint-marginal
// rule, whose nodes are zero beyond the 7 joint angles (rdim = 7).  The
// phi-only and the moments variant, float32 and float64, entered through
// gvi_quad (quad.cu -> quad.cuh quad_entry, cost kArmSdfCost).
//
// Why its own layout.  quad.cuh puts one or two lanes on a factor and
// keeps the factor's covariance, Cholesky factor and moment sums in
// registers: at D = 14 that is 196 + 196 + 120 values a lane, and the
// cost is ~700 operations a node, so a lane walking 15 nodes in series
// leaves the moments' launch (1024 x 10 factors) a partial wave of long
// threads.  Here a group of kArmGroup = 16 lanes owns a factor and lane j
// takes nodes j, j + 16, ... (one node a lane on the (7, 2) rule of 15):
//
// * Every lane loads the covariance's first 7 columns and takes their
//   Cholesky factor L7 = [L11; L21] itself (L11 7 x 7, L21 7 x 7; the
//   phi variant takes L11 alone): a node z zero beyond 7 places at
//   d = L7 z, the same offsets as the whole factor's place_node gives
//   (the trailing columns meet zeros), without the trailing 7 x 7 factor.
// * phi: each lane sums w phi and |w phi| over its nodes, the group's
//   sums meet in an xor butterfly, lane 0 stores the guarded E[phi]
//   (guard_phi: the cancellation and the nonneg guard, the JAX package's).
// * moments: each round the group's lanes stage their node's w phi and 14
//   offsets in shared memory; lane l then adds the nodes of the round, in
//   node order, into its 8 of the 120 sums (E[phi], E[d phi], the lower
//   triangle of E[d d^T phi]).  The sums, staged, leave as three
//   contiguous runs (16 neighbouring words a store), the lower triangle
//   mirrored, with the marginal rule's lift added where both indices are
//   trailing: (C22 - L21 L21^T) E[phi], which is L[:, 7:] L[:, 7:]^T
//   E[phi] (sigma.cuh lifted_moment) without the trailing factor.
//
// quant = 1 rounds each offset through bfloat16 and back (sigma.cuh
// place_node's rounded branch; the trailing offsets sum the 7 leading
// products as the zero-padded node's do).  The sums run in a fixed order
// with no atomics: two launches give the same bits.
#include "quad.cuh"

namespace gvi {

constexpr int kArmD = 14;                  // local dim
constexpr int kArmR = ArmSdfCost::kJoints; // the rule's dims: joint angles
constexpr int kArmGroup = 16;              // lanes a factor
constexpr int kArmThreads = 128;           // threads a block
constexpr int kArmFactors = kArmThreads / kArmGroup;
constexpr int kArmSums = 1 + kArmD + kArmD * (kArmD + 1) / 2;  // 120
constexpr int kArmPerLane = (kArmSums + kArmGroup - 1) / kArmGroup;
// a node's staged values: its 14 offsets, 1 (so that E[phi] and E[d phi]
// are products like the rest), w phi
constexpr int kArmNode = kArmD + 2;
// a factor's shared memory: L21 (7 x 7), then a round's nodes (the
// sums, once complete, in their place)
constexpr int kArmStage = kArmR * kArmR + kArmGroup * kArmNode;

// Sum e of the 120 as the product of two staged values of a node (times
// its w phi): E[phi] = 1 * 1, E[d_i phi] = d_i * 1, then the lower
// triangle of E[d d^T phi] row by row, d_i * d_j.
__device__ __forceinline__ void arm_sum_factors(int e, int& a, int& b) {
  if (e == 0) {
    a = b = kArmD;
  } else if (e <= kArmD) {
    a = e - 1;
    b = kArmD;
  } else {
    int t = e - 1 - kArmD, i = 0;
    while (t > i) t -= ++i;
    a = i;
    b = t;
  }
}

template <typename T>
__device__ __forceinline__ T place_sum(T t, T nd, T l, int quant) {
  return quant ? add_rn(t, mul_rn(nd, l)) : t + nd * l;
}

template <typename T, bool WithMoments>
__global__ void __launch_bounds__(kArmThreads)
    quad_arm_kernel(const QuadOperands<T> op) {
  extern __shared__ unsigned char smem_raw[];
  T* s_nodes = reinterpret_cast<T*>(smem_raw);  // [kArmR, m]
  T* s_w = s_nodes + op.m * kArmR;              // [m]
  for (int t = threadIdx.x; t < op.m * kArmR; t += blockDim.x) {
    const int node = t / kArmR, i = t - node * kArmR;
    s_nodes[i * op.m + node] = op.nodes[node * kArmD + i];
  }
  for (int t = threadIdx.x; t < op.m; t += blockDim.x) s_w[t] = op.weights[t];
  __syncthreads();

  const int lane = threadIdx.x & (kArmGroup - 1);
  const unsigned f = (blockIdx.x * blockDim.x + threadIdx.x) / kArmGroup;
  // a group past the last factor repeats it and stores nothing: every lane
  // of the warp takes part in the butterflies and the warp's barriers
  const unsigned fl = f < op.count ? f : op.count - 1;
  const unsigned b = fl / op.k, kk = fl - b * op.k;
  const T* cov = op.cov + b * op.cov_sb + kk * op.cov_sk;
  const T* p = op.params + (int64_t)(fl % op.period) * ArmSdfCost::kParams;
  T mu[kArmD];
  load_row(op.mu + b * op.mu_sb + kk * op.mu_sk, mu);

  // L11: the Cholesky factor of the leading 7 x 7 block (smallmat.cuh
  // chol's order)
  T l11[kArmR][kArmR];
#pragma unroll
  for (int j = 0; j < kArmR; ++j) {
    T acc = __ldg(cov + j * kArmD + j);
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - l11[j][k] * l11[j][k];
    const T ljj = dsqrt(acc);
    l11[j][j] = ljj;
    const T inv = T(1) / ljj;
#pragma unroll
    for (int i = j + 1; i < kArmR; ++i) {
      T acc2 = __ldg(cov + i * kArmD + j);
#pragma unroll
      for (int k = 0; k < j; ++k) acc2 = acc2 - l11[i][k] * l11[j][k];
      l11[i][j] = acc2 * inv;
    }
#pragma unroll
    for (int i = 0; i < j; ++i) l11[i][j] = T(0);
  }

  if (!WithMoments) {
    T acc = T(0), absum = T(0);
    for (int mi = lane; mi < op.m; mi += kArmGroup) {
      T nd[kArmR], pts[kArmR], diff[kArmR];
#pragma unroll
      for (int i = 0; i < kArmR; ++i) nd[i] = s_nodes[i * op.m + mi];
      place_node(nd, l11, reinterpret_cast<const T(&)[kArmR]>(mu), op.quant,
                 diff, pts);
      const T wphi = ArmSdfCost::eval<T, kArmR>(pts, p, op.field) * s_w[mi];
      acc = acc + wphi;
      absum = absum + dabs(wphi);
    }
    acc = group_sum(acc, kArmGroup);
    absum = group_sum(absum, kArmGroup);
    if (f < op.count && lane == 0)
      op.e_phi[f] = guard_phi(acc, absum, op.nonneg);
    return;
  }

  // L21 = C21 L11^-T, row by row
  T l21[kArmR][kArmR];
#pragma unroll
  for (int i = 0; i < kArmR; ++i) {
#pragma unroll
    for (int j = 0; j < kArmR; ++j) {
      T acc = __ldg(cov + (kArmR + i) * kArmD + j);
#pragma unroll
      for (int k = 0; k < j; ++k) acc = acc - l21[i][k] * l11[j][k];
      l21[i][j] = acc * (T(1) / l11[j][j]);
    }
  }

  T* stage = reinterpret_cast<T*>(s_w + op.m) +
             (threadIdx.x / kArmGroup) * kArmStage;
  T* s_l21 = stage;                    // [7][7]
  T* s_node = stage + kArmR * kArmR;   // [kArmGroup][kArmNode]
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kArmR; ++i)
#pragma unroll
      for (int j = 0; j < kArmR; ++j) s_l21[i * kArmR + j] = l21[i][j];
  }
  int fa[kArmPerLane], fb[kArmPerLane];
  T sums[kArmPerLane];
#pragma unroll
  for (int q = 0; q < kArmPerLane; ++q) {
    const int e = lane + q * kArmGroup;
    arm_sum_factors(e < kArmSums ? e : 0, fa[q], fb[q]);
    sums[q] = T(0);
  }

  for (int base = 0; base < op.m; base += kArmGroup) {
    const int mi = base + lane;
    if (mi < op.m) {
      T nd[kArmR], pts[kArmR], diff[kArmR];
#pragma unroll
      for (int i = 0; i < kArmR; ++i) nd[i] = s_nodes[i * op.m + mi];
      place_node(nd, l11, reinterpret_cast<const T(&)[kArmR]>(mu), op.quant,
                 diff, pts);
      T* mine = s_node + lane * kArmNode;
#pragma unroll
      for (int i = 0; i < kArmR; ++i) mine[i] = diff[i];
#pragma unroll
      for (int i = 0; i < kArmR; ++i) {
        T t = op.quant ? mul_rn(nd[0], l21[i][0]) : nd[0] * l21[i][0];
#pragma unroll
        for (int j = 1; j < kArmR; ++j) t = place_sum(t, nd[j], l21[i][j],
                                                      op.quant);
        mine[kArmR + i] = op.quant ? round_bf16(t) : t;
      }
      mine[kArmD] = T(1);
      mine[kArmD + 1] =
          ArmSdfCost::eval<T, kArmR>(pts, p, op.field) * s_w[mi];
    }
    __syncwarp();
    const int nodes = min(kArmGroup, op.m - base);
    for (int n = 0; n < nodes; ++n) {
      const T* node = s_node + n * kArmNode;
      const T wphi = node[kArmD + 1];
#pragma unroll
      for (int q = 0; q < kArmPerLane; ++q)
        sums[q] = sums[q] + wphi * node[fa[q]] * node[fb[q]];
    }
    __syncwarp();
  }

  // the sums into the staging area, then out as three runs
  T* s_sums = s_node;
#pragma unroll
  for (int q = 0; q < kArmPerLane; ++q) {
    const int e = lane + q * kArmGroup;
    if (e < kArmSums) s_sums[e] = sums[q];
  }
  __syncwarp();
  if (f >= op.count) return;
  const T e_phi = s_sums[0];
  if (lane == 0) op.e_phi[f] = e_phi;
  if (lane < kArmD) op.e_xmu[(int64_t)f * kArmD + lane] = s_sums[1 + lane];
  T* out = op.e_xxt + (int64_t)f * kArmD * kArmD;
  for (int idx = lane; idx < kArmD * kArmD; idx += kArmGroup) {
    const int r = idx / kArmD, c = idx - r * kArmD;
    const int i = max(r, c), j = min(r, c);
    T val = s_sums[1 + kArmD + i * (i + 1) / 2 + j];
    if (j >= op.rdim) {
      // the lift: (C22 - L21 L21^T)_ij E[phi]
      const T* li = s_l21 + (i - kArmR) * kArmR;
      const T* lj = s_l21 + (j - kArmR) * kArmR;
      T corr = __ldg(cov + i * kArmD + j);
#pragma unroll
      for (int t = 0; t < kArmR; ++t) corr = corr - li[t] * lj[t];
      val = val + corr * e_phi;
    }
    out[idx] = val;
  }
}

template <typename T, bool WithMoments>
int launch_quad_arm(const QuadOperands<T>& op, int threads, cudaStream_t st) {
  // the layout is compiled in: kernels/quad.py ARM_GROUP, QUAD_THREADS;
  // the lift takes the joint-marginal rule only
  if (op.group_shift != 4 || threads != kArmThreads ||
      (WithMoments && op.rdim != kArmR))
    return -1;
  const int64_t lanes = (int64_t)op.count * kArmGroup;
  const int blocks = (int)((lanes + threads - 1) / threads);
  size_t values = (size_t)op.m * (kArmR + 1);
  if (WithMoments) values += (size_t)kArmFactors * kArmStage;
  quad_arm_kernel<T, WithMoments>
      <<<blocks, threads, sizeof(T) * values, st>>>(op);
  return static_cast<int>(cudaGetLastError());
}

template int launch_quad_arm<float, false>(const QuadOperands<float>&, int,
                                           cudaStream_t);
template int launch_quad_arm<float, true>(const QuadOperands<float>&, int,
                                          cudaStream_t);
template int launch_quad_arm<double, false>(const QuadOperands<double>&, int,
                                            cudaStream_t);
template int launch_quad_arm<double, true>(const QuadOperands<double>&, int,
                                           cudaStream_t);

}  // namespace gvi
