// The fused NGD gradient kernel, mode "accum": one rank's partial joint gradients
// (fused_gradient.cuh has the kernel and says what each mode computes).
#include "fused_gradient.cuh"

GVI_GRAD_ENTRY(gvi_fused_grad_accum, gvi::kGradAccum)
