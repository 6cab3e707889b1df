// Cost functors for the quadrature kernel.
//
// The JAX package traces a Python callable (``lanes_cost``) into its Pallas
// kernel; CUDA cannot take one.  Each nonlinear cost the kernels support is
// instead a functor here, passed to the kernel as a template parameter.  A
// factor batch names its functor with ``kernel_cost`` (Python side:
// gaussianvi_tpu_torch/kernels/quad.py, KERNEL_COSTS) and carries its
// params packed per factor, leaves in sorted-key order, as ``[.., K, P]``.
//
// Contract: ``kParams`` is P; ``eval(x, p)`` returns phi at the point x of
// the factor's local dimension D given the factor's P params.
#pragma once

#include "smallmat.cuh"

namespace gvi {

enum CostId : int { kRangeCost = 0 };

// Range measurement (gaussianvi_tpu/examples/chain_estimation.py,
// range_cost_lanes): phi = (r - |pos - beacon|)^2 / (2 sig_r^2) with pos the
// leading DX entries of x.  Params: beacon[DX], r, sig_r_sq.
template <int DX>
struct RangeCost {
  static constexpr int kParams = DX + 2;

  template <typename T, int D>
  __device__ __forceinline__ static T eval(const T (&x)[D],
                                           const T (&p)[kParams]) {
    static_assert(DX <= D, "range cost reads the leading DX coordinates");
    T d2 = T(0);
#pragma unroll
    for (int j = 0; j < DX; ++j) {
      const T t = x[j] - p[j];
      d2 = d2 + t * t;
    }
    const T dist = dsqrt(d2 + T(1e-12));
    const T res = p[DX] - dist;
    return res * res / (T(2) * p[DX + 1]);
  }
};

}  // namespace gvi
