// Chain kernels over a batch of block-tridiagonal SPD precisions.
//
// Replaces the TPU kernels of gaussianvi_tpu/kernels/chain_lanes.py:
//   gvi_gbp   <- gbp_covariance_logdet_lanes (_gbp_kernel): GBP forward and
//                backward sweeps, covariance diag/off blocks from one 2s x 2s
//                Cholesky inverse per edge, Kahan-compensated log det
//                NaN-poisoned by the 8-eps pivot-trust guard;
//   gvi_solve <- solve_lanes (_solve_kernel): block-Thomas solve A x = b.
//
// Design: one thread per chain; the whole chain recurrence runs in that
// thread's registers with the s x s algebra unrolled (smallmat.cuh).
// Arrays are batch-last ([element, chain]) so a warp's 32 chains read and
// write neighbouring addresses.  Forward pivots (K1) or Cholesky factors
// (K2) go to a global scratch array that the wrapper allocates.
//
// What bounds it on the card: latency of the serial s x s algebra along
// the chain (each step depends on the previous one); parallelism exists
// only across problems.  At B = 1024 (2048 chains for K2, 11264 for K1 on
// the line-search batch) that is a few hundred to a few thousand warps
// for 132 SMs, so occupancy is low.  Later work can give each chain a
// warp (parallel over the s x s entries) or pack more problems per SM.
#include "smallmat.cuh"

namespace gvi {

template <typename T, int S>
__global__ void __launch_bounds__(64)
gbp_kernel(const T* __restrict__ diag, const T* __restrict__ off,
           T* __restrict__ covd, T* __restrict__ covo, T* __restrict__ ld_out,
           T* __restrict__ fpiv, T* __restrict__ gpiv, int nb, int n) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int64_t blk = (int64_t)S * S * nb;  // stride of one s x s block
  diag += b; off += b; covd += b; covo += b; fpiv += b; gpiv += b;

  // forward sweep: pivots F_i = D_i + f_i, log det, pivot trust
  T m[S][S];
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) m[r][c] = T(0);
  T ld = T(0), comp = T(0), trust = T(1);
  for (int i = 0; i < n; ++i) {
    T d[S][S], piv[S][S], l[S][S];
    load_mat(diag + i * blk, nb, d);
    add_mat(d, m, piv);
    store_mat(fpiv + i * blk, nb, piv);
    chol(piv, l);
    trust = pivot_trust(l, piv, d, m, trust);
    kahan_add(ld, comp, logdet_from_chol(l));
    if (i < n - 1) {
      T bo[S][S];
      load_mat(off + i * blk, nb, bo);
      fwd_message(l, bo, m);
    }
  }
  ld_out[b] = trust >= pivot_trust_tol<T>() ? ld : quiet_nan<T>();

  // backward sweep: G_i = D_i + b_i
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) m[r][c] = T(0);
  for (int i = n - 1; i >= 0; --i) {
    T d[S][S], piv[S][S];
    load_mat(diag + i * blk, nb, d);
    add_mat(d, m, piv);
    store_mat(gpiv + i * blk, nb, piv);
    if (i > 0) {
      T l[S][S], bo[S][S];
      chol(piv, l);
      load_mat(off + (i - 1) * blk, nb, bo);
      bwd_message(l, bo, m);
    }
  }

  if (n == 1) {
    T d[S][S], l[S][S], inv[S][S];
    load_mat(diag, nb, d);
    chol(d, l);
    inv_from_chol(l, inv);
    store_mat(covd, nb, inv);
    return;
  }

  // edges: invert [[F_i, B_i], [B_i^T, G_{i+1}]]
  for (int i = 0; i < n - 1; ++i) {
    T f[S][S], g[S][S], bo[S][S], cii[S][S], cjj[S][S], cij[S][S];
    load_mat(fpiv + i * blk, nb, f);
    load_mat(gpiv + (i + 1) * blk, nb, g);
    load_mat(off + i * blk, nb, bo);
    edge_covariance(f, g, bo, cii, cjj, cij);
    store_mat(covd + i * blk, nb, cii);
    store_mat(covo + i * blk, nb, cij);
    if (i == n - 2) store_mat(covd + (int64_t)(n - 1) * blk, nb, cjj);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(64)
solve_kernel(const T* __restrict__ diag, const T* __restrict__ off,
             const T* __restrict__ rhs, T* __restrict__ x_out,
             T* __restrict__ lfac, int nb, int n) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int64_t blk = (int64_t)S * S * nb;
  const int64_t vec = (int64_t)S * nb;
  diag += b; off += b; rhs += b; x_out += b; lfac += b;

  // forward: pivots, their Cholesky factors (kept in scratch for the back
  // sweep), and the eliminated rhs y_i = b_i - B_{i-1}^T F_{i-1}^{-1} y_{i-1}
  // (stored in x_out, overwritten by the back sweep)
  T m[S][S], lprev[S][S], yprev[S];
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) m[r][c] = T(0);
  for (int i = 0; i < n; ++i) {
    T d[S][S], piv[S][S], l[S][S], y[S];
    load_mat(diag + i * blk, nb, d);
    add_mat(d, m, piv);
    chol(piv, l);
    store_mat(lfac + i * blk, nb, l);
#pragma unroll
    for (int r = 0; r < S; ++r) y[r] = rhs[i * vec + (int64_t)r * nb];
    if (i > 0) {
      T bo[S][S], sol[S];
      load_mat(off + (i - 1) * blk, nb, bo);
      chol_solve_vec(lprev, yprev, sol);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        T acc = y[r];
#pragma unroll
        for (int k = 0; k < S; ++k) acc = acc - bo[k][r] * sol[k];
        y[r] = acc;
      }
    }
#pragma unroll
    for (int r = 0; r < S; ++r) x_out[i * vec + (int64_t)r * nb] = y[r];
    if (i < n - 1) {
      T bo[S][S];
      load_mat(off + i * blk, nb, bo);
      fwd_message(l, bo, m);
    }
#pragma unroll
    for (int r = 0; r < S; ++r) {
      yprev[r] = y[r];
#pragma unroll
      for (int c = 0; c < S; ++c) lprev[r][c] = l[r][c];
    }
  }

  // back: x_i = F_i^{-1} (y_i - B_i x_{i+1}); the last state has no B-term
  // (selected, never multiplied by an unset value)
  T xnext[S];
  for (int i = n - 1; i >= 0; --i) {
    T l[S][S], r_[S], sol[S];
    load_mat(lfac + i * blk, nb, l);
#pragma unroll
    for (int r = 0; r < S; ++r) r_[r] = x_out[i * vec + (int64_t)r * nb];
    if (i < n - 1) {
      T bo[S][S];
      load_mat(off + i * blk, nb, bo);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < S; ++c) acc = acc + bo[r][c] * xnext[c];
        r_[r] = r_[r] - acc;
      }
    }
    chol_solve_vec(l, r_, sol);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      x_out[i * vec + (int64_t)r * nb] = sol[r];
      xnext[r] = sol[r];
    }
  }
}

constexpr int kChainThreads = 64;

inline int blocks_for(int nb) { return (nb + kChainThreads - 1) / kChainThreads; }

template <typename T, int S>
int launch_gbp(const void* diag, const void* off, void* covd, void* covo,
               void* ld, void* fpiv, void* gpiv, int nb, int n,
               cudaStream_t st) {
  gbp_kernel<T, S><<<blocks_for(nb), kChainThreads, 0, st>>>(
      static_cast<const T*>(diag), static_cast<const T*>(off),
      static_cast<T*>(covd), static_cast<T*>(covo), static_cast<T*>(ld),
      static_cast<T*>(fpiv), static_cast<T*>(gpiv), nb, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch_solve(const void* diag, const void* off, const void* rhs, void* x,
                 void* lfac, int nb, int n, cudaStream_t st) {
  solve_kernel<T, S><<<blocks_for(nb), kChainThreads, 0, st>>>(
      static_cast<const T*>(diag), static_cast<const T*>(off),
      static_cast<const T*>(rhs), static_cast<T*>(x), static_cast<T*>(lfac),
      nb, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gvi

// dtype: 0 = float32, 1 = float64.  Returns the cudaError_t of the launch
// (0 = success) or -1 for a (dtype, s) that is not instantiated.
extern "C" int gvi_gbp(int dtype, int s, const void* diag, const void* off,
                       void* covd, void* covo, void* ld, void* fpiv,
                       void* gpiv, int nb, int n, void* stream) {
  if (nb <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && s == 2) return gvi::launch_gbp<float, 2>(diag, off, covd, covo, ld, fpiv, gpiv, nb, n, st);
  if (dtype == 0 && s == 4) return gvi::launch_gbp<float, 4>(diag, off, covd, covo, ld, fpiv, gpiv, nb, n, st);
  if (dtype == 1 && s == 2) return gvi::launch_gbp<double, 2>(diag, off, covd, covo, ld, fpiv, gpiv, nb, n, st);
  if (dtype == 1 && s == 4) return gvi::launch_gbp<double, 4>(diag, off, covd, covo, ld, fpiv, gpiv, nb, n, st);
  return -1;
}

extern "C" int gvi_solve(int dtype, int s, const void* diag, const void* off,
                         const void* rhs, void* x, void* lfac, int nb, int n,
                         void* stream) {
  if (nb <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && s == 2) return gvi::launch_solve<float, 2>(diag, off, rhs, x, lfac, nb, n, st);
  if (dtype == 0 && s == 4) return gvi::launch_solve<float, 4>(diag, off, rhs, x, lfac, nb, n, st);
  if (dtype == 1 && s == 2) return gvi::launch_solve<double, 2>(diag, off, rhs, x, lfac, nb, n, st);
  if (dtype == 1 && s == 4) return gvi::launch_solve<double, 4>(diag, off, rhs, x, lfac, nb, n, st);
  return -1;
}
