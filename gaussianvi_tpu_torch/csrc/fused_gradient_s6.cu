// The fused NGD gradient kernel, mode "full", at s = 6 (the 3-D planners,
// chain estimation at dim_x = 3) with the range and the 3-D SDF cost:
// fused_gradient.cuh launch_grad sends s = 6 here.  A translation unit of
// its own, so that nvcc compiles these four instances, which take it longer
// than the rest of the library, beside the others.
#include "fused_gradient.cuh"

namespace gvi {

int launch_grad_full_s6(int dtype, int cost, int np, const void* mu,
                        const void* pd, const void* po, const void* temp,
                        void* covd, void* covo, void* ld, void* dpd,
                        void* dpo, void* dmu, void* dfb, void* vdmu,
                        void* vdd, void* vdo, void* scratch, int nb, int n,
                        int warps, long long chain, int n_nl,
                        void* const* nl_ptrs, const int* nl_ints, int n_lin,
                        void* const* lin_ptrs, const int* lin_ints,
                        cudaStream_t st) {
#define GVI_GRAD(T, COST)                                                     \
  if (np != COST::kParams) return -1;                                        \
  return dispatch_grad<T, 6, COST, kGradFull>(                               \
      mu, pd, po, temp, covd, covo, ld, dpd, dpo, dmu, dfb, vdmu, vdd, vdo,   \
      scratch, nb, n, warps, chain, n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs,  \
      lin_ints, st);
  if (cost == kRangeCost) {
    if (dtype == 0) { GVI_GRAD(float, RangeCost<3>) }
    if (dtype == 1) { GVI_GRAD(double, RangeCost<3>) }
  }
  if (cost == kSdf3dCost) {
    if (dtype == 0) { GVI_GRAD(float, Sdf3dCost) }
    if (dtype == 1) { GVI_GRAD(double, Sdf3dCost) }
  }
#undef GVI_GRAD
  return -1;
}

}  // namespace gvi
