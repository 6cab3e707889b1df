// The fused NGD gradient kernel, mode "solve": from the summed partial gradients to the step
// (fused_gradient.cuh has the kernel and says what each mode computes).
#include "fused_gradient.cuh"

GVI_GRAD_ENTRY(gvi_fused_grad_solve, gvi::kGradSolve)
