// The fused NGD gradient kernel, mode "full", at s = 6 (the 3-D planners,
// chain estimation at dim_x = 3) with the range and the 3-D SDF cost and
// the 3-D SDF's patch mode: fused_gradient.cuh launch_grad sends s = 6
// here.  A translation unit of its own, so that nvcc compiles these six
// instances, which take it longer than the rest of the library, beside the
// others.
#include "fused_gradient_s6.cuh"

namespace gvi {

GVI_GRAD_S6_DEFINE_WINDOWS(launch_grad_full_s6, kGradFull)

}  // namespace gvi
