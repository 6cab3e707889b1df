// The fused NGD gradient kernel, mode "full": the whole NGD gradient step
// (fused_gradient.cuh has the kernel and says what each mode computes).
#include "fused_gradient.cuh"

GVI_GRAD_ENTRY(gvi_fused_grad, gvi::kGradFull)
