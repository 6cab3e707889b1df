// Block-form sigma-point moments (K4), the Cholesky taken in the kernel.
//
// Replaces the TPU kernel gaussianvi_tpu/kernels/fused_moments.py,
// fused_moments (_moments_kernel): from a factor's marginal mean and
// covariance, take the Cholesky factor L, place the sigma points
// x_m = mu + L node_m, evaluate the cost once per point, and reduce
//   E[phi]                = sum_m w_m phi_m
//   E[(x-mu) phi]         = sum_m w_m phi_m (L node_m)
//   E[(x-mu)(x-mu)^T phi] = sum_m w_m phi_m (L node_m)(L node_m)^T
// in one pass; the sigma points never reach device memory.  For a marginal
// rule (nodes over the leading rdim dims, zero-padded) the closed-form lift
// L[:, rdim:] L[:, rdim:]^T E[phi] is added to the second moment.  No
// guards: this is the gradient path.
//
// This is the function of the quadrature kernel's moments variant (quad.cu,
// K3), and on the card it is the same kernel: quad.cuh's body, laid out by
// the same plan, under this entry.  The TPU kernel evaluates a tile of 8
// factors x all M nodes in one vector pass with the Cholesky factor taken
// outside; here the first port did that too, and its call was 8x its
// kernel: the Cholesky ran as dozens of small PyTorch ops before every
// launch.  Now one call is one launch and no PyTorch op.  What bounds it:
// at the block-form path's 1024 x 32 factors (d = 4, 29 nodes, float32) it
// moves 5.9 MB, 2 us at the memory rate; with 2 lanes per factor
// (quad.cuh, kernels/quad.py quad_plan) the call is one partial wave,
// 0.008 ms on an H100 (0.13-0.20 ms for the first port's call), the
// latency of one group's nodes, butterfly and stores (PERF.md, section 6).
#include "quad.cuh"

// Operands as gvi_quad takes them (strides in elements, the params'
// period in factors, the cost's field, contiguous outputs; rdim = d
// disables the lift).  The field passes through to the shared body: no
// batch with a field reaches this kernel today (the planners' obstacle
// batches have no block form, as in the JAX package), but every cost the
// body is instantiated for takes its operands here too, except the two
// patch-mode costs (no batch of theirs has a block form either).
// Returns the cudaError_t of the launch (0 = success) or -1 for a
// (dtype, d, cost, np) combination that is not instantiated.
extern "C" int gvi_fused_moments(int dtype, int d, int cost, const void* mu,
                                 long long mu_sb, long long mu_sk,
                                 const void* cov, long long cov_sb,
                                 long long cov_sk, const void* nodes,
                                 const void* weights, const void* params,
                                 long long period, const void* field,
                                 int rows, int cols, int depth, void* e_phi,
                                 void* e_xmu, void* e_xxt, long long count,
                                 int k, int m, int np, int rdim,
                                 int group_shift, int threads, void* stream) {
  if (count <= 0) return 0;
  if (dtype == 0)
    return gvi::quad_entry<float, true, false>(
        d, cost, np, mu, mu_sb, mu_sk, cov, cov_sb, cov_sk, nodes, weights,
        params, period, field, rows, cols, depth, e_phi, e_xmu, e_xxt, count,
        k, m, 0, rdim, 0, group_shift, threads, stream);
  if (dtype == 1)
    return gvi::quad_entry<double, true, false>(
        d, cost, np, mu, mu_sb, mu_sk, cov, cov_sb, cov_sk, nodes, weights,
        params, period, field, rows, cols, depth, e_phi, e_xmu, e_xxt, count,
        k, m, 0, rdim, 0, group_shift, threads, stream);
  return -1;
}
