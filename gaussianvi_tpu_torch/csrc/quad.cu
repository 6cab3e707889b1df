// Per-factor sigma-point quadrature with the cost evaluated in-kernel (K3).
//
// Replaces the TPU kernel gaussianvi_tpu/kernels/quad_lanes.py, quad_lanes
// (_quad_kernel), in both variants:
//   phi only  (with_moments = 0): E[phi], NaN-poisoned by the 64-ulp
//             cancellation test and, for nonnegative costs, the 4096-ulp
//             nonneg band (line-search cost path);
//   moments   (with_moments = 1): E[phi], E[(x-mu) phi],
//             E[(x-mu)(x-mu)^T phi] with the closed-form quad_rdim lift
//             L[:, r:] L[:, r:]^T E[phi] for marginal rules (gradient path);
// either with the TPU kernel's eval_dtype: quant = 1 rounds every sigma
// offset through bfloat16 and back (sigma.cuh place_node).
// The kernel body is quad.cuh's, which the block-form moments kernel
// (fused_moments.cu, K4) shares; the 7-DOF arm's cost (kArmSdfCost, d =
// 14) takes quad_arm.cu's layout through the same entry.
//
// What bounds it on the card: bytes and the arithmetic per node are both
// small.  The phi variant on the line-search batch (11 x 1024 x 32
// factors, d = 4, 29 nodes, float32) moves 30.8 MB, 9 us at the memory
// rate, and evaluates 10.5 M sigma points (a square root and a division
// each); the moments variant (1024 x 32 factors) moves 5.9 MB, 2 us.  The
// first port took one thread per factor, all M nodes in series, behind
// wrapper copies of every operand to a batch-last layout (twice the call's
// bytes before the kernel started) and, for 32,768 factors, 12% of the
// card's resident threads.  The design (quad.cuh) reads the operands where
// PyTorch holds them (strides, the params' broadcast as a period) and
// spreads a factor's nodes over a group of lanes where the card would
// otherwise idle (kernels/quad.py quad_plan, measured on an H100: PERF.md,
// section 6): one thread per factor for the phi variant, whose batch fills
// the card by itself (every further lane repeats the factor's loads,
// Cholesky and reduction), and 2 lanes for the moments variant, whose
// results leave through a per-warp staging area as contiguous runs.
// Measured there (f32, flagship): phi 0.081 -> 0.022 ms, 2.4x its bound,
// with 1.3 waves of warps and the per-node square root and division in
// series; moments 0.018 -> 0.008 ms, one partial wave whose time is the
// latency of one group's nodes, butterfly and stores.
#include "quad.cuh"

// Returns the cudaError_t of the launch (0 = success) or -1 for a
// (dtype, d, cost, np) combination that is not instantiated.  mu and cov
// are read at batch / factor strides mu_sb, mu_sk, cov_sb, cov_sk
// (elements), params as rows of np, factor f reading row f % period, the
// cost's field as depth x rows x cols values (depth 1 for a planar field;
// null, 0, 0, 0 for the range cost); the outputs are contiguous.
// group = 1 << group_shift lanes per factor, threads per block a multiple
// of 32.
extern "C" int gvi_quad(int dtype, int d, int cost, int with_moments,
                        const void* mu, long long mu_sb, long long mu_sk,
                        const void* cov, long long cov_sb, long long cov_sk,
                        const void* nodes, const void* weights,
                        const void* params, long long period,
                        const void* field, int rows, int cols, int depth,
                        void* e_phi, void* e_xmu, void* e_xxt,
                        long long count, int k, int m, int np, int nonneg,
                        int rdim, int quant, int group_shift, int threads,
                        void* stream) {
  if (count <= 0) return 0;
#define GVI_QUAD(T, M)                                                       \
  gvi::quad_entry<T, M>(d, cost, np, mu, mu_sb, mu_sk, cov, cov_sb, cov_sk, \
                        nodes, weights, params, period, field, rows, cols,   \
                        depth, e_phi, e_xmu, e_xxt, count, k, m, nonneg,     \
                        rdim, quant, group_shift, threads, stream)
  if (dtype == 0)
    return with_moments ? GVI_QUAD(float, true) : GVI_QUAD(float, false);
  if (dtype == 1)
    return with_moments ? GVI_QUAD(double, true) : GVI_QUAD(double, false);
#undef GVI_QUAD
  return -1;
}
