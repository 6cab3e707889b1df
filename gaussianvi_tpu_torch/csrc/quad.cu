// Per-factor sigma-point quadrature with the cost evaluated in-kernel.
//
// Replaces the TPU kernel gaussianvi_tpu/kernels/quad_lanes.py, quad_lanes
// (_quad_kernel), in both variants:
//   phi only  (WithMoments = false): E[phi], NaN-poisoned by the 64-ulp
//             cancellation test and, for nonnegative costs, the 4096-ulp
//             nonneg band (line-search cost path);
//   moments   (WithMoments = true): E[phi], E[(x-mu) phi],
//             E[(x-mu)(x-mu)^T phi] with the closed-form quad_rdim lift
//             L[:, r:] L[:, r:]^T E[phi] for marginal rules (gradient path).
//
// Design: one thread per (problem, factor) pair.  The thread Choleskys its
// marginal covariance, walks the M rule nodes (held in shared memory, one
// copy per block), evaluates the cost functor once per node and keeps the
// weighted sums in registers.  Inputs and outputs are batch-last
// ([element, pair]) so a warp's loads and stores coalesce.
//
// What bounds it on the card: per-node arithmetic (D^2/2 FMAs for the
// sigma offset, the cost, and D^2/2 more for the moments) serialised over
// the M nodes of one thread; memory traffic is one marginal in and a few
// moments out per pair.  The trial batch (11 * 1024 * 32 pairs) fills the
// card; the moments call at B = 1024 has 32,768 pairs, 256 blocks for 132
// SMs, so occupancy is low there.  Later work can split the node loop of
// a pair across a warp, or fuse this into the gradient kernel.
#include "costs.cuh"

namespace gvi {

constexpr int kQuadThreads = 128;

template <typename T, int D, typename Cost, bool WithMoments>
__global__ void __launch_bounds__(kQuadThreads)
quad_kernel(const T* __restrict__ mu, const T* __restrict__ cov,
            const T* __restrict__ nodes, const T* __restrict__ weights,
            const T* __restrict__ params, T* __restrict__ e_phi,
            T* __restrict__ e_xmu, T* __restrict__ e_xxt, int count, int m,
            int nonneg, int rdim) {
  extern __shared__ unsigned char smem_raw[];
  T* s_nodes = reinterpret_cast<T*>(smem_raw);  // [m, D]
  T* s_w = s_nodes + m * D;                     // [m]
  for (int t = threadIdx.x; t < m * D; t += blockDim.x) s_nodes[t] = nodes[t];
  for (int t = threadIdx.x; t < m; t += blockDim.x) s_w[t] = weights[t];
  __syncthreads();

  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  const int64_t nc = count;

  T c[D][D], l[D][D], mu_k[D];
  load_mat(cov + idx, nc, c);
  chol(c, l);
#pragma unroll
  for (int i = 0; i < D; ++i) mu_k[i] = mu[i * nc + idx];
  T p[Cost::kParams];
#pragma unroll
  for (int j = 0; j < Cost::kParams; ++j) p[j] = params[j * nc + idx];

  constexpr int NT = D * (D + 1) / 2;
  T acc = T(0), absum = T(0), acc_x[D], acc_xx[NT];
#pragma unroll
  for (int i = 0; i < D; ++i) acc_x[i] = T(0);
#pragma unroll
  for (int t = 0; t < NT; ++t) acc_xx[t] = T(0);

  for (int mi = 0; mi < m; ++mi) {
    const T* nd = s_nodes + mi * D;
    T diff[D], pts[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T t = nd[0] * l[i][0];
#pragma unroll
      for (int j = 1; j <= i; ++j) t = t + nd[j] * l[i][j];
      diff[i] = t;
      pts[i] = t + mu_k[i];
    }
    const T wphi = Cost::template eval<T, D>(pts, p) * s_w[mi];
    acc = acc + wphi;
    if (WithMoments) {
      int t = 0;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const T wd = wphi * diff[i];
        acc_x[i] = acc_x[i] + wd;
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          acc_xx[t] = acc_xx[t] + wd * diff[j];
          ++t;
        }
      }
    } else {
      absum = absum + dabs(wphi);
    }
  }

  if (!WithMoments) {
    const T eps = Eps<T>::value;
    bool bad = dabs(acc) < T(64) * eps * absum;
    if (nonneg) bad = bad || (acc < T(0) && acc > -T(4096) * eps * absum);
    e_phi[idx] = bad ? quiet_nan<T>() : acc;
    return;
  }
  e_phi[idx] = acc;
#pragma unroll
  for (int i = 0; i < D; ++i) e_xmu[i * nc + idx] = acc_x[i];
  int t = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T val = acc_xx[t++];
      if (j >= rdim) {
        // marginal-rule lift: corr_ij = sum_{tt = rdim..j} L_i,tt L_j,tt
        T corr = T(0);
        bool first = true;
#pragma unroll
        for (int tt = 0; tt <= j; ++tt) {
          if (tt >= rdim) {
            const T term = l[i][tt] * l[j][tt];
            corr = first ? term : corr + term;
            first = false;
          }
        }
        val = val + corr * acc;
      }
      e_xxt[(i * D + j) * nc + idx] = val;
      if (j != i) e_xxt[(j * D + i) * nc + idx] = val;
    }
  }
}

template <typename T, int D, typename Cost>
int launch_quad(bool with_moments, const void* mu, const void* cov,
                const void* nodes, const void* weights, const void* params,
                void* e_phi, void* e_xmu, void* e_xxt, int count, int m,
                int nonneg, int rdim, cudaStream_t st) {
  const int blocks = (count + kQuadThreads - 1) / kQuadThreads;
  const size_t smem = sizeof(T) * (size_t)m * (D + 1);
  const T* mu_ = static_cast<const T*>(mu);
  const T* cov_ = static_cast<const T*>(cov);
  const T* nodes_ = static_cast<const T*>(nodes);
  const T* w_ = static_cast<const T*>(weights);
  const T* p_ = static_cast<const T*>(params);
  T* phi_ = static_cast<T*>(e_phi);
  T* xmu_ = static_cast<T*>(e_xmu);
  T* xxt_ = static_cast<T*>(e_xxt);
  if (with_moments)
    quad_kernel<T, D, Cost, true><<<blocks, kQuadThreads, smem, st>>>(
        mu_, cov_, nodes_, w_, p_, phi_, xmu_, xxt_, count, m, nonneg, rdim);
  else
    quad_kernel<T, D, Cost, false><<<blocks, kQuadThreads, smem, st>>>(
        mu_, cov_, nodes_, w_, p_, phi_, xmu_, xxt_, count, m, nonneg, rdim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_quad(int d, int cost, bool with_moments, int np, const void* mu,
                  const void* cov, const void* nodes, const void* weights,
                  const void* params, void* e_phi, void* e_xmu, void* e_xxt,
                  int count, int m, int nonneg, int rdim, cudaStream_t st) {
  if (cost == kRangeCost && d == 2 && np == RangeCost<1>::kParams)
    return launch_quad<T, 2, RangeCost<1>>(with_moments, mu, cov, nodes, weights, params,
                                           e_phi, e_xmu, e_xxt, count, m, nonneg, rdim, st);
  if (cost == kRangeCost && d == 4 && np == RangeCost<2>::kParams)
    return launch_quad<T, 4, RangeCost<2>>(with_moments, mu, cov, nodes, weights, params,
                                           e_phi, e_xmu, e_xxt, count, m, nonneg, rdim, st);
  return -1;
}

}  // namespace gvi

// dtype: 0 = float32, 1 = float64.  rdim = d disables the marginal lift.
// Returns the cudaError_t of the launch (0 = success) or -1 for a
// (dtype, d, cost, np) combination that is not instantiated.
extern "C" int gvi_quad(int dtype, int d, int cost, int with_moments,
                        const void* mu, const void* cov, const void* nodes,
                        const void* weights, const void* params, void* e_phi,
                        void* e_xmu, void* e_xxt, int count, int m, int np,
                        int nonneg, int rdim, void* stream) {
  if (count <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gvi::dispatch_quad<float>(d, cost, with_moments != 0, np, mu, cov, nodes, weights,
                                     params, e_phi, e_xmu, e_xxt, count, m, nonneg, rdim, st);
  if (dtype == 1)
    return gvi::dispatch_quad<double>(d, cost, with_moments != 0, np, mu, cov, nodes, weights,
                                      params, e_phi, e_xmu, e_xxt, count, m, nonneg, rdim, st);
  return -1;
}
