// Block-form sigma-point moments: one warp per factor, the rule's nodes
// across the lanes.
//
// Replaces the TPU kernel gaussianvi_tpu/kernels/fused_moments.py,
// fused_moments (_moments_kernel): from a factor's marginal mean and the
// Cholesky factor L of its covariance, place the sigma points
// x_m = mu + L node_m, evaluate the cost once per point, and reduce
//   E[phi]                = sum_m w_m phi_m
//   E[(x-mu) phi]         = sum_m w_m phi_m (L node_m)
//   E[(x-mu)(x-mu)^T phi] = sum_m w_m phi_m (L node_m)(L node_m)^T
// in one pass; the sigma points never reach device memory.  For a marginal
// rule (nodes over the leading rdim dims, zero-padded) the closed-form lift
// L[:, rdim:] L[:, rdim:]^T E[phi] is added to the second moment, as the
// quadrature kernel (quad.cu) does.  No guards: this is the gradient path.
//
// Design: the TPU kernel evaluates a tile of 8 factors x all M nodes in one
// vector pass.  Here a warp owns one factor: lane t takes nodes t, t + 32,
// ..., keeps its 1 + D + D(D+1)/2 partial sums in registers, and a
// butterfly of warp shuffles leaves every lane with the totals, so lanes
// 0 .. D*D-1 each write one output entry.  Operands are factor-major
// (the public [K, ...] layout, no transposes in the wrapper): a warp reads
// its factor's 1 + D + D*D + P input words as broadcast loads.  The rule
// sits in shared memory, one copy per block of kWarps factors.
//
// What bounds it on the card: the work is tiny beside the card's rates
// (tens of bytes and a few thousand operations per factor), so the time is
// launch latency plus, per warp, one pass of ceil(M / 32) cost evaluations
// and the shuffle reduction (5 steps x 15 sums at D = 4).  Against the
// quadrature kernel's one thread per factor (M evaluations in series) the
// serial depth falls from M to ceil(M / 32) + the reduction.
#include "sigma.cuh"

namespace gvi {

constexpr int kWarps = 4;  // factors per block

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D, typename Cost>
__global__ void __launch_bounds__(32 * kWarps)
moments_kernel(const T* __restrict__ mu, const T* __restrict__ chol_l,
               const T* __restrict__ nodes, const T* __restrict__ weights,
               const T* __restrict__ params, T* __restrict__ e_phi,
               T* __restrict__ e_xmu, T* __restrict__ e_xxt, int count, int m,
               int rdim) {
  extern __shared__ unsigned char smem_raw[];
  T* s_nodes = reinterpret_cast<T*>(smem_raw);  // [m, D]
  T* s_w = s_nodes + m * D;                     // [m]
  for (int t = threadIdx.x; t < m * D; t += blockDim.x) s_nodes[t] = nodes[t];
  for (int t = threadIdx.x; t < m; t += blockDim.x) s_w[t] = weights[t];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t k = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= count) return;  // the whole warp leaves together

  T l[D][D], mu_k[D], p[Cost::kParams];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    mu_k[i] = mu[k * D + i];
#pragma unroll
    for (int j = 0; j < D; ++j) l[i][j] = chol_l[(k * D + i) * D + j];
  }
#pragma unroll
  for (int j = 0; j < Cost::kParams; ++j) p[j] = params[k * Cost::kParams + j];

  T acc, absum, acc_x[D], acc_xx[Tri<D>::value];
  sigma_sums<T, D, Cost, true>(l, mu_k, p, s_nodes, s_w, m, acc, absum, acc_x,
                               acc_xx, lane, 32);
  acc = warp_sum(acc);
#pragma unroll
  for (int i = 0; i < D; ++i) acc_x[i] = warp_sum(acc_x[i]);
#pragma unroll
  for (int t = 0; t < Tri<D>::value; ++t) acc_xx[t] = warp_sum(acc_xx[t]);

  // every lane holds the totals: lane i*D + j writes entry (i, j)
  if (lane == 0) e_phi[k] = acc;
  int t = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (lane == i) e_xmu[k * D + i] = acc_x[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const T val = lifted_moment(acc_xx[t++], l, i, j, rdim, acc);
      if (lane == i * D + j) e_xxt[(k * D + i) * D + j] = val;
      if (j != i && lane == j * D + i) e_xxt[(k * D + j) * D + i] = val;
    }
  }
}

template <typename T, int D, typename Cost>
int launch_moments(const void* mu, const void* chol_l, const void* nodes,
                   const void* weights, const void* params, void* e_phi,
                   void* e_xmu, void* e_xxt, int count, int m, int rdim,
                   cudaStream_t st) {
  static_assert(D * D <= 32, "one lane per second-moment entry");
  const int blocks = (count + kWarps - 1) / kWarps;
  const size_t smem = sizeof(T) * (size_t)m * (D + 1);
  moments_kernel<T, D, Cost><<<blocks, 32 * kWarps, smem, st>>>(
      static_cast<const T*>(mu), static_cast<const T*>(chol_l),
      static_cast<const T*>(nodes), static_cast<const T*>(weights),
      static_cast<const T*>(params), static_cast<T*>(e_phi),
      static_cast<T*>(e_xmu), static_cast<T*>(e_xxt), count, m, rdim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_moments(int d, int cost, int np, const void* mu,
                     const void* chol_l, const void* nodes,
                     const void* weights, const void* params, void* e_phi,
                     void* e_xmu, void* e_xxt, int count, int m, int rdim,
                     cudaStream_t st) {
  if (cost == kRangeCost && d == 2 && np == RangeCost<1>::kParams)
    return launch_moments<T, 2, RangeCost<1>>(mu, chol_l, nodes, weights, params, e_phi,
                                              e_xmu, e_xxt, count, m, rdim, st);
  if (cost == kRangeCost && d == 4 && np == RangeCost<2>::kParams)
    return launch_moments<T, 4, RangeCost<2>>(mu, chol_l, nodes, weights, params, e_phi,
                                              e_xmu, e_xxt, count, m, rdim, st);
  return -1;
}

}  // namespace gvi

// dtype: 0 = float32, 1 = float64.  All operands factor-major and
// contiguous: mu [count, d], chol_l [count, d, d] (lower factor), params
// [count, np]; outputs e_phi [count], e_xmu [count, d], e_xxt [count, d, d].
// rdim = d disables the marginal lift.  Returns the cudaError_t of the
// launch (0 = success) or -1 for a (dtype, d, cost, np) combination that is
// not instantiated.
extern "C" int gvi_fused_moments(int dtype, int d, int cost, const void* mu,
                                 const void* chol_l, const void* nodes,
                                 const void* weights, const void* params,
                                 void* e_phi, void* e_xmu, void* e_xxt,
                                 int count, int m, int np, int rdim,
                                 void* stream) {
  if (count <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gvi::dispatch_moments<float>(d, cost, np, mu, chol_l, nodes, weights, params,
                                        e_phi, e_xmu, e_xxt, count, m, rdim, st);
  if (dtype == 1)
    return gvi::dispatch_moments<double>(d, cost, np, mu, chol_l, nodes, weights, params,
                                         e_phi, e_xmu, e_xxt, count, m, rdim, st);
  return -1;
}
