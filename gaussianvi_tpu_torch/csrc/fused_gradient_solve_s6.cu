// The fused NGD gradient kernel, mode "solve", at s = 6 (from the summed
// partial gradients to the step, at the shapes of fused_gradient_accum_s6.cu):
// fused_gradient.cuh launch_grad sends s = 6 here, a translation unit of its
// own as fused_gradient_s6.cu is.
#include "fused_gradient_s6.cuh"

namespace gvi {

GVI_GRAD_S6_DEFINE(launch_grad_solve_s6, kGradSolve)

}  // namespace gvi
