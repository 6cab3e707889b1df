// Sigma-point sums of one factor: the quadrature core shared by the
// quadrature kernels (quad.cuh: quad.cu and fused_moments.cu) and the fused
// kernels (fused_trials.cu, fused_gradient.cu).
//
// For a factor with marginal N(mu, L L^T) and a rule (nodes, weights) in
// shared memory, each node gives the offset d = L node (summed in the order
// of gaussianvi_tpu/kernels/quad_lanes.py) and the point x = mu + d, where
// the cost functor is evaluated once (with the batch's field, for a cost
// that reads one).  The sums kept in registers are
// sum w phi and either sum |w phi| (the cost path's guards) or the central
// moments sum w phi d and sum w phi d d^T (lower triangle, row-major).
//
// sigma_sums: one thread takes the nodes first, first + step, ... of a
// factor from a node-major rule [m][D] (the fused kernels).
// group_sigma_sums + group_sum: a group of G lanes shares one factor, lane
// j taking nodes j, j + G, ... from a coordinate-major rule [D][m], so the
// group's lanes read neighbouring words; a butterfly then leaves every lane
// of the group with the totals (the quadrature kernels).
//
// quant (a runtime flag, the same for every thread of a launch): 1 rounds
// each offset through bfloat16 and back before the point is placed and the
// moments are summed (centered quantization, moments_eval_dtype; the TPU
// kernels' `t.astype(eval_dtype).astype(t.dtype)`).  That branch forms the
// offset with round-to-nearest products and sums, never a fused
// multiply-add, so that it has the bits of the plain PyTorch version
// (factors/moments.py kernel_offsets): a one-ulp difference before the
// round trip would be a bfloat16 ulp (2^-8 relative) after it.  A double
// rounds through float first, as PyTorch and the JAX package round it.
// quant = 0 keeps the contracted arithmetic of the unquantized kernels.
#pragma once

#include <cuda_bf16.h>

#include "costs.cuh"

namespace gvi {

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ double round_bf16(double x) {
  return static_cast<double>(
      __bfloat162float(__float2bfloat16_rn(static_cast<float>(x))));
}

// Offsets d = L nd of one node (rows summed from column 0 up) and its
// point x = mu + d; quant as above.
template <typename T, int D>
__device__ __forceinline__ void place_node(const T* nd, const T (&l)[D][D],
                                           const T (&mu)[D], int quant,
                                           T (&diff)[D], T (&pts)[D]) {
  if (quant) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T t = mul_rn(nd[0], l[i][0]);
#pragma unroll
      for (int j = 1; j <= i; ++j) t = add_rn(t, mul_rn(nd[j], l[i][j]));
      t = round_bf16(t);
      diff[i] = t;
      pts[i] = t + mu[i];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T t = nd[0] * l[i][0];
#pragma unroll
    for (int j = 1; j <= i; ++j) t = t + nd[j] * l[i][j];
    diff[i] = t;
    pts[i] = t + mu[i];
  }
}

template <int D>
struct Tri {
  static constexpr int value = D * (D + 1) / 2;
};

template <typename T, int D, typename Cost, bool WithMoments>
__device__ __forceinline__ void sigma_sums(const T (&l)[D][D],
                                           const T (&mu)[D],
                                           const T (&p)[Cost::kParams],
                                           const Field<T>& field,
                                           const T* s_nodes, const T* s_w,
                                           int m, T& acc, T& absum,
                                           T (&acc_x)[D],
                                           T (&acc_xx)[Tri<D>::value],
                                           int quant, int first = 0,
                                           int step = 1) {
  acc = T(0);
  absum = T(0);
#pragma unroll
  for (int i = 0; i < D; ++i) acc_x[i] = T(0);
#pragma unroll
  for (int t = 0; t < Tri<D>::value; ++t) acc_xx[t] = T(0);
  for (int mi = first; mi < m; mi += step) {
    T diff[D], pts[D];
    place_node(s_nodes + mi * D, l, mu, quant, diff, pts);
    const T wphi = Cost::template eval<T, D>(pts, p, field) * s_w[mi];
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
}

template <typename T, int D, typename Cost, bool WithMoments>
__device__ __forceinline__ void group_sigma_sums(
    const T (&l)[D][D], const T (&mu)[D], const T (&p)[Cost::kParams],
    const Field<T>& field, const T* s_nodes, const T* s_w, int m, int lane,
    int group, T& acc, T& absum, T (&acc_x)[D],
    T (&acc_xx)[Tri<D>::value], int quant) {
  acc = T(0);
  absum = T(0);
#pragma unroll
  for (int i = 0; i < D; ++i) acc_x[i] = T(0);
#pragma unroll
  for (int t = 0; t < Tri<D>::value; ++t) acc_xx[t] = T(0);
  for (int mi = lane; mi < m; mi += group) {
    T nd[D], diff[D], pts[D];
#pragma unroll
    for (int i = 0; i < D; ++i) nd[i] = s_nodes[i * m + mi];
    place_node(nd, l, mu, quant, diff, pts);
    const T wphi = Cost::template eval<T, D>(pts, p, field) * s_w[mi];
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
}

// Sum over an aligned group of `group` lanes (a power of two up to 32) by
// an xor butterfly: every lane ends with the same bits, since each step
// adds the same two values on both sides.  Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int group) {
  for (int o = group >> 1; o > 0; o >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// E[phi] poisoned to NaN when its sign cannot be trusted: |sum| below 64
// ulps of sum |w phi| (cancellation), or, for a nonnegative cost, a
// negative sum inside the 4096-ulp rounding band (factors/moments.py).
template <typename T>
__device__ __forceinline__ T guard_phi(T acc, T absum, int nonneg) {
  const T eps = Eps<T>::value;
  bool bad = dabs(acc) < T(64) * eps * absum;
  if (nonneg) bad = bad || (acc < T(0) && acc > -T(4096) * eps * absum);
  return bad ? quiet_nan<T>() : acc;
}

// Entry (i, j), j <= i, of E[(x-mu)(x-mu)^T phi] with the closed-form
// marginal-rule lift: a rule over the leading rdim dims zero-padded to D
// misses L[:, rdim:] L[:, rdim:]^T E[phi], added here where j >= rdim.
template <typename T, int D>
__device__ __forceinline__ T lifted_moment(T val, const T (&l)[D][D], int i,
                                           int j, int rdim, T e_phi) {
  if (j < rdim) return val;
  T corr = T(0);
  bool first = true;
#pragma unroll
  for (int tt = 0; tt < D; ++tt) {
    if (tt >= rdim && tt <= j) {
      const T term = l[i][tt] * l[j][tt];
      corr = first ? term : corr + term;
      first = false;
    }
  }
  return val + corr * e_phi;
}

}  // namespace gvi
