// The fused NGD gradient kernel, mode "accum", at s = 6 (one rank's partial
// joint gradients of the 3-D planners and of chain estimation at dim_x = 3)
// with the range and the 3-D SDF cost and the 3-D SDF's patch mode:
// fused_gradient.cuh launch_grad sends s = 6 here, a translation unit of
// its own as fused_gradient_s6.cu is.
#include "fused_gradient_s6.cuh"

namespace gvi {

GVI_GRAD_S6_DEFINE_WINDOWS(launch_grad_accum_s6, kGradAccum)

}  // namespace gvi
