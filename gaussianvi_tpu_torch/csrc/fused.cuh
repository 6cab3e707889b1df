// Factor operands of the fused kernels (fused_trials.cu, fused_gradient.cu)
// and the per-factor algebra both kernels share.
//
// A graph reaches the fused kernels as up to kMaxBatches nonlinear and
// kMaxBatches linear factor batches (gaussianvi_tpu_torch/kernels/
// fused_trials.py builds them, as gaussianvi_tpu/inference/engine.py's
// _build_fused_specs does):
//   nonlinear (nb == 1): a quadrature rule (nodes [m, S], weights [m]),
//     per-problem packed cost params [k * P, B] (batch-last), and the
//     support of factor k: state offset + k, or starts[k];
//   linear (span 1 or 2 states): the residual form of
//     cost = <A, Sig> + (Lam mu - pm)^T prec_c (Lam mu - pm) per row
//     (fused_trials.linear_residual_form), rows [ka, ...] per problem
//     (ka == 1 for a uniform batch: every factor reads row 0).
// The C entry points take them as flat host arrays of pointers and ints
// (parse_factors), passed to the kernel by value as a __grid_constant__
// struct, so a kernel indexes the batches without a local copy.
#pragma once

#include "sigma.cuh"

namespace gvi {

constexpr int kMaxBatches = 4;
constexpr int kNLPtrs = 5;   // nodes, weights, params, starts, fc
constexpr int kNLInts = 5;   // k, m, offset, nonneg, rdim
constexpr int kLinPtrs = 6;  // a, lam, pm, prec, starts, fc
constexpr int kLinInts = 5;  // span, k, ka, r, offset

template <typename T>
struct NLBatch {
  const T* nodes;
  const T* weights;
  const T* params;    // [k * P, B]
  const int* starts;  // [k], or nullptr: factor k sits at state offset + k
  T* fc;              // trial kernel: E[phi] out, [k, T * B]
  int k, m, offset, nonneg, rdim;
  int smem;           // element offset of the rule in shared memory
};

template <typename T>
struct LinBatch {
  const T* a;         // [ka * blocks * S * S, B]; blocks: A, or A11 A22 A12
  const T* lam;       // [ka * r * span * S, B]
  const T* pm;        // [ka * r, B]
  const T* prec;      // [ka * r * r, B]
  const int* starts;  // [k], or nullptr: factor k sits at offset + k
  T* fc;              // trial kernel: cost out, [k, T * B]
  int span, k, ka, r, offset;
};

template <typename T>
struct Factors {
  NLBatch<T> nl[kMaxBatches];
  LinBatch<T> lin[kMaxBatches];
  int n_nl, n_lin;
};

// Host: fill the struct from the flat arrays; false for too many batches.
// smem_bytes receives the shared memory the rules take (S + 1 values per
// node).
template <typename T, int S>
inline bool parse_factors(int n_nl, void* const* nl_ptrs, const int* nl_ints,
                          int n_lin, void* const* lin_ptrs,
                          const int* lin_ints, Factors<T>& f,
                          size_t& smem_bytes) {
  if (n_nl < 0 || n_nl > kMaxBatches || n_lin < 0 || n_lin > kMaxBatches)
    return false;
  f = Factors<T>{};
  f.n_nl = n_nl;
  f.n_lin = n_lin;
  int off = 0;
  for (int j = 0; j < n_nl; ++j) {
    void* const* p = nl_ptrs + j * kNLPtrs;
    const int* q = nl_ints + j * kNLInts;
    NLBatch<T>& b = f.nl[j];
    b.nodes = static_cast<const T*>(p[0]);
    b.weights = static_cast<const T*>(p[1]);
    b.params = static_cast<const T*>(p[2]);
    b.starts = static_cast<const int*>(p[3]);
    b.fc = static_cast<T*>(p[4]);
    b.k = q[0];
    b.m = q[1];
    b.offset = q[2];
    b.nonneg = q[3];
    b.rdim = q[4];
    b.smem = off;
    off += b.m * (S + 1);
  }
  for (int j = 0; j < n_lin; ++j) {
    void* const* p = lin_ptrs + j * kLinPtrs;
    const int* q = lin_ints + j * kLinInts;
    LinBatch<T>& b = f.lin[j];
    b.a = static_cast<const T*>(p[0]);
    b.lam = static_cast<const T*>(p[1]);
    b.pm = static_cast<const T*>(p[2]);
    b.prec = static_cast<const T*>(p[3]);
    b.starts = static_cast<const int*>(p[4]);
    b.fc = static_cast<T*>(p[5]);
    b.span = q[0];
    b.k = q[1];
    b.ka = q[2];
    b.r = q[3];
    b.offset = q[4];
  }
  smem_bytes = sizeof(T) * static_cast<size_t>(off);
  return true;
}

// Every thread of the block copies its share of every rule into shared
// memory; callers return early only after this barrier.
template <typename T, int S>
__device__ __forceinline__ void load_rules(const Factors<T>& f, T* smem) {
  for (int j = 0; j < f.n_nl; ++j) {
    const NLBatch<T>& b = f.nl[j];
    T* dst = smem + b.smem;
    for (int t = threadIdx.x; t < b.m * S; t += blockDim.x) dst[t] = b.nodes[t];
    for (int t = threadIdx.x; t < b.m; t += blockDim.x)
      dst[b.m * S + t] = b.weights[t];
  }
  __syncthreads();
}

// fn(k) for every factor k of a batch whose support starts at state i.
template <typename Fn>
__device__ __forceinline__ void for_factors_at(const int* starts, int offset,
                                               int k_count, int i, Fn&& fn) {
  if (starts == nullptr) {
    const int k = i - offset;
    if (k >= 0 && k < k_count) fn(k);
  } else {
    for (int k = 0; k < k_count; ++k)
      if (starts[k] == i) fn(k);
  }
}

// Packed params of factor k for problem lane b of nb.
template <typename T, typename Cost>
__device__ __forceinline__ void load_params(const NLBatch<T>& fb, int k,
                                            int64_t nb, int64_t b,
                                            T (&p)[Cost::kParams]) {
#pragma unroll
  for (int j = 0; j < Cost::kParams; ++j)
    p[j] = fb.params[((int64_t)k * Cost::kParams + j) * nb + b];
}

// Residual rows (Lam mu - pm) of row kk of a linear batch whose factors
// span DE = span * S values, then the weighted rows w = prec_c (Lam mu -
// pm); rows beyond r (at most MaxR) are zero.  Sums in index order, as
// fused_trials._resid_cost / fused_gradient._lin_resid_w.
template <typename T, int DE, int MaxR>
__device__ __forceinline__ void lin_residual(const LinBatch<T>& lb, int kk,
                                             int64_t nb, int64_t b,
                                             const T (&mu)[DE],
                                             T (&res)[MaxR], T (&w)[MaxR]) {
#pragma unroll
  for (int rr = 0; rr < MaxR; ++rr) {
    res[rr] = T(0);
    if (rr < lb.r) {
      const int64_t row = (int64_t)kk * lb.r + rr;
      T acc = -lb.pm[row * nb + b];
#pragma unroll
      for (int d = 0; d < DE; ++d)
        acc = acc + lb.lam[(row * DE + d) * nb + b] * mu[d];
      res[rr] = acc;
    }
  }
#pragma unroll
  for (int rr = 0; rr < MaxR; ++rr) {
    w[rr] = T(0);
    if (rr < lb.r) {
      const int64_t row = ((int64_t)kk * lb.r + rr) * lb.r;
      T acc = lb.prec[row * nb + b] * res[0];
#pragma unroll
      for (int cc = 1; cc < MaxR; ++cc)
        if (cc < lb.r) acc = acc + lb.prec[(row + cc) * nb + b] * res[cc];
      w[rr] = acc;
    }
  }
}

// Block blk (0: A or A11, 1: A22, 2: A12) of row kk of A.
template <typename T, int S>
__device__ __forceinline__ void load_a(const LinBatch<T>& lb, int kk, int blk,
                                       int64_t nb, int64_t b,
                                       T (&a)[S][S]) {
  const int blocks = lb.span == 2 ? 3 : 1;
  load_mat(lb.a + (((int64_t)kk * blocks + blk) * S * S) * nb + b, nb, a);
}

}  // namespace gvi
