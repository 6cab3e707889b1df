// Small-matrix SPD algebra for one thread: the shared device library of
// the chain and quadrature kernels (and of the fused kernels to come).
//
// Every matrix is a register array indexed by compile-time constants
// (loops over S are unrolled), so nothing touches local memory as long as
// the caller's working set fits the register file.  The operation order
// follows the JAX package's unrolled recurrences
// (gaussianvi_tpu/kernels/chain_lanes.py: _chol, _chol_solve_vec,
// _pivot_trust, _logdet_from_chol), so kernel and plain versions round
// alike up to FMA contraction.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace gvi {

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr float value = 1.1920928955078125e-07f; };
template <> struct Eps<double> { static constexpr double value = 2.220446049250313e-16; };

// NaN-propagating minimum (jnp.minimum / torch.minimum semantics; fmin
// would drop the NaN and let a poisoned pivot pass the trust test).
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  if (a != a || b != b) return quiet_nan<T>();
  return a < b ? a : b;
}

// Lower Cholesky factor of SPD a (S x S).  A non-SPD input gives NaN
// entries, never a trap.
template <typename T, int S>
__device__ __forceinline__ void chol(const T (&a)[S][S], T (&l)[S][S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    T acc = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - l[j][k] * l[j][k];
    const T ljj = dsqrt(acc);
    l[j][j] = ljj;
    const T inv = T(1) / ljj;
#pragma unroll
    for (int i = j + 1; i < S; ++i) {
      T acc2 = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc2 = acc2 - l[i][k] * l[j][k];
      l[i][j] = acc2 * inv;
    }
#pragma unroll
    for (int i = 0; i < j; ++i) l[i][j] = T(0);
  }
}

// Solve (L L^T) x = b for one vector.
template <typename T, int S>
__device__ __forceinline__ void chol_solve_vec(const T (&l)[S][S],
                                               const T (&b)[S], T (&x)[S]) {
  T y[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    T acc = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - l[i][k] * y[k];
    y[i] = acc / l[i][i];
  }
#pragma unroll
  for (int i = S - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int k = i + 1; k < S; ++k) acc = acc - l[k][i] * x[k];
    x[i] = acc / l[i][i];
  }
}

// 2 * sum_j log L_jj
template <typename T, int S>
__device__ __forceinline__ T logdet_from_chol(const T (&l)[S][S]) {
  T acc = dlog(l[0][0]);
#pragma unroll
  for (int j = 1; j < S; ++j) acc = acc + dlog(l[j][j]);
  return T(2) * acc;
}

// Running minimum of the pivot-trust statistic of piv = d + m with
// Cholesky l: L_jj^2 / (|d_jj| + |m_jj| + |piv_jj - L_jj^2|), the
// surviving pivot mass against everything that cancelled to produce it.
// Below 8 eps (pivot_trust_tol) the logdet is noise and is poisoned.
template <typename T, int S>
__device__ __forceinline__ T pivot_trust(const T (&l)[S][S],
                                         const T (&piv)[S][S],
                                         const T (&d)[S][S],
                                         const T (&m)[S][S], T trust) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const T numer = l[j][j] * l[j][j];
    const T denom = dabs(d[j][j]) + dabs(m[j][j]) + dabs(piv[j][j] - numer);
    trust = nan_min(trust, numer / denom);
  }
  return trust;
}

template <typename T>
__device__ __forceinline__ T pivot_trust_tol() {
  return T(8) * Eps<T>::value;
}

// Kahan-compensated running sum: sum += term.
template <typename T>
__device__ __forceinline__ void kahan_add(T& sum, T& comp, T term) {
  const T t = term - comp;
  const T s = sum + t;
  comp = (s - sum) - t;
  sum = s;
}

// Batch-last ("lanes") addressing: element e of problem b in an array of
// nb problems lives at [e * nb + b], so the threads of a warp, one problem
// each, read neighbouring addresses.
template <typename T, int R, int C>
__device__ __forceinline__ void load_mat(const T* base, int64_t nb,
                                         T (&a)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) a[r][c] = base[(int64_t)(r * C + c) * nb];
}

template <typename T, int R, int C>
__device__ __forceinline__ void store_mat(T* base, int64_t nb,
                                          const T (&a)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) base[(int64_t)(r * C + c) * nb] = a[r][c];
}

}  // namespace gvi
