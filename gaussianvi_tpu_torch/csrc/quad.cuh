// The sigma-point quadrature kernel body shared by the quadrature kernel
// (quad.cu, K3: phi-only and moments variants) and the block-form moments
// kernel (fused_moments.cu, K4: the moments variant under its own entry).
//
// Layout: a group of `group` lanes (a power of two up to 32; which one,
// kernels/quad.py quad_plan decides) owns one factor.  Every lane of the
// group reads the factor's mean, covariance and params (16-byte loads
// where the row is aligned: the group's lanes read the same words, so a
// warp's load touches only its factors' rows) and takes the Cholesky
// itself: the warp issues those instructions once for all its factors, so
// sharing them out by shuffles would only add instructions.  Lane j then
// walks the rule's nodes j, j + group, ... (group_sigma_sums, sigma.cuh)
// and the group's sums meet in an xor butterfly (group_sum).  The phi
// variant's lane 0 stores E[phi]; the moments variant stages its warp's
// factors' 1 + D + D * D values in shared memory (entry e written by lane
// e % group) and the warp stores each output array's run of them with
// neighbouring lanes on neighbouring words.
//
// Operands as PyTorch holds them: mu [nb, K, D] and cov [nb, K, D, D] at
// any batch and factor strides (in elements) with the D or D x D block
// dense, params [period, P] dense with factor f reading row f % period
// (their broadcast over leading axes), the cost's field (one array every
// factor reads in place; costs.cuh Field), outputs contiguous [count],
// [count, D], [count, D, D] with f = b * K + k.  The rule is staged once
// per block in shared memory, coordinate-major ([D][m] nodes, then [m]
// weights), so the group's lanes read neighbouring words; the moments'
// staging area follows it.  The sums run in a fixed order with no
// atomics: two launches give the same bits.
#pragma once

#include <cstring>

#include "sigma.cuh"

namespace gvi {

// N values stored contiguously at src, in 16- or 8-byte pieces where the
// row's size and address allow, else one by one.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* src, T (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if (kBytes % 16 == 0 && at % 16 == 0) {
#pragma unroll
    for (int j = 0; j < kBytes / 16; ++j) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(src) + j);
      memcpy(reinterpret_cast<char*>(out) + 16 * j, &v, 16);
    }
  } else if (kBytes % 8 == 0 && at % 8 == 0) {
#pragma unroll
    for (int j = 0; j < kBytes / 8; ++j) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(src) + j);
      memcpy(reinterpret_cast<char*>(out) + 8 * j, &v, 8);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = __ldg(src + j);
  }
}

// Where the factor's operands are and how the launch is laid out.  Factor
// indices are 32-bit (the wrapper keeps count << group_shift below 2^31):
// a 64-bit division per thread would cost as much as a few nodes.
template <typename T>
struct QuadOperands {
  const T* mu;
  const T* cov;
  const T* nodes;    // [m, D] node-major, as the caller holds the rule
  const T* weights;  // [m]
  const T* params;
  Field<T> field;    // the cost's field (null data for a cost without one)
  T* e_phi;
  T* e_xmu;
  T* e_xxt;
  int64_t mu_sb, mu_sk, cov_sb, cov_sk;
  unsigned count, k, period;
  int m, group_shift, nonneg, rdim;
  int quant;         // 1: offsets rounded through bfloat16 (sigma.cuh)
};

// K3 at the 7-DOF arm's shapes (d = 14, ArmSdfCost, the joint-marginal
// rule): a factor on a group of 16 lanes, built in quad_arm.cu; -1 for a
// layout or rule it is not built for.
template <typename T, bool WithMoments>
int launch_quad_arm(const QuadOperands<T>& op, int threads, cudaStream_t st);

// Internal linkage: quad.cu and fused_moments.cu each build their own
// instances, so no kernel is registered twice.
namespace {

// Values a factor's moments take in a warp's staging area: E[phi], then
// E[(x-mu) phi], then E[(x-mu)(x-mu)^T phi] row-major.
template <int D>
struct Staged {
  static constexpr int value = 1 + D + D * D;
};

template <typename T, int D, typename Cost, bool WithMoments>
__global__ void quad_kernel(const QuadOperands<T> op) {
  extern __shared__ unsigned char smem_raw[];
  T* s_nodes = reinterpret_cast<T*>(smem_raw);  // [D, m]
  T* s_w = s_nodes + op.m * D;                  // [m]
  for (int t = threadIdx.x; t < op.m * D; t += blockDim.x)
    s_nodes[(t % D) * op.m + t / D] = op.nodes[t];
  for (int t = threadIdx.x; t < op.m; t += blockDim.x) s_w[t] = op.weights[t];
  __syncthreads();

  const int group = 1 << op.group_shift;
  const int lane = threadIdx.x & (group - 1);
  const unsigned f = (blockIdx.x * blockDim.x + threadIdx.x) >> op.group_shift;
  // a group past the last factor repeats it and stores nothing: every lane
  // of the warp takes part in the butterflies
  const unsigned fl = f < op.count ? f : op.count - 1;
  const unsigned b = fl / op.k, kk = fl - b * op.k;

  T c[D][D], l[D][D], mu_k[D], p[Cost::kParams];
  load_row(op.mu + b * op.mu_sb + kk * op.mu_sk, mu_k);
  load_row(op.cov + b * op.cov_sb + kk * op.cov_sk,
           reinterpret_cast<T(&)[D * D]>(c));
  load_row(op.params + (int64_t)(fl % op.period) * Cost::kParams, p);
  chol(c, l);

  T acc, absum, acc_x[D], acc_xx[Tri<D>::value];
  group_sigma_sums<T, D, Cost, WithMoments>(l, mu_k, p, op.field, s_nodes,
                                            s_w, op.m, lane, group, acc,
                                            absum, acc_x, acc_xx, op.quant);
  acc = group_sum(acc, group);
  if (!WithMoments) {
    absum = group_sum(absum, group);
    if (f < op.count && lane == 0)
      op.e_phi[f] = guard_phi(acc, absum, op.nonneg);
    return;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) acc_x[i] = group_sum(acc_x[i], group);
#pragma unroll
  for (int t = 0; t < Tri<D>::value; ++t) acc_xx[t] = group_sum(acc_xx[t], group);

  // The warp's factors are consecutive: their moments go through the
  // warp's staging area (the group's lanes share its writes, entry e by
  // lane e % group) and leave as three contiguous runs, one store of
  // neighbouring words per lane and step.
  constexpr int E = Staged<D>::value;
  const int per_warp = 32 >> op.group_shift;
  T* s_out = s_w + op.m + (threadIdx.x >> 5) * per_warp * E;
  T* mine = s_out + ((threadIdx.x & 31) >> op.group_shift) * E;
  const int mask = group - 1;
  if (lane == 0) mine[0] = acc;
#pragma unroll
  for (int i = 0; i < D; ++i)
    if (lane == ((1 + i) & mask)) mine[1 + i] = acc_x[i];
  int t = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const T val = lifted_moment(acc_xx[t++], l, i, j, op.rdim, acc);
      if (lane == ((1 + D + i * D + j) & mask)) mine[1 + D + i * D + j] = val;
      if (j != i && lane == ((1 + D + j * D + i) & mask))
        mine[1 + D + j * D + i] = val;
    }
  }
  __syncwarp();
  const unsigned f0 = f - ((threadIdx.x & 31) >> op.group_shift);
  if (f0 >= op.count) return;
  const unsigned nf = min((unsigned)per_warp, op.count - f0);
  const int w = threadIdx.x & 31;
  for (unsigned q = w; q < nf; q += 32) op.e_phi[f0 + q] = s_out[q * E];
  for (unsigned q = w; q < nf * D; q += 32)
    op.e_xmu[(int64_t)f0 * D + q] = s_out[(q / D) * E + 1 + q % D];
  for (unsigned q = w; q < nf * D * D; q += 32)
    op.e_xxt[(int64_t)f0 * D * D + q] =
        s_out[(q / (D * D)) * E + 1 + D + q % (D * D)];
}

template <typename T, int D, typename Cost, bool WithMoments>
int launch_quad(const QuadOperands<T>& op, int threads, cudaStream_t st) {
  const int64_t lanes = (int64_t)op.count << op.group_shift;
  const int blocks = (int)((lanes + threads - 1) / threads);
  size_t values = (size_t)op.m * (D + 1);  // the rule
  if (WithMoments)  // each warp's staging area
    values += ((size_t)threads >> op.group_shift) * Staged<D>::value;
  quad_kernel<T, D, Cost, WithMoments>
      <<<blocks, threads, sizeof(T) * values, st>>>(op);
  return static_cast<int>(cudaGetLastError());
}

// The C entries' common body: the instantiated (d, cost, np)
// combinations (range at d = 2, 4, 6; the planar SDF and its patch mode at
// d = 2, 4; the 3-D SDF and its patch mode at d = 6; the arm at d = 14,
// quad_arm.cu; Windows = false, K4's, leaves the two patch-mode costs and
// the arm out), -1 for any other; strides and the
// params' period in elements / factors; field: the cost's depth x rows x
// cols field (depth 1 for a planar one; null, 0, 0, 0 for a cost without
// one); rdim = d disables the lift; quant 1 rounds the offsets through
// bfloat16.
template <typename T, bool WithMoments, bool Windows = true>
int quad_entry(int d, int cost, int np, const void* mu,
               long long mu_sb, long long mu_sk, const void* cov,
               long long cov_sb, long long cov_sk, const void* nodes,
               const void* weights, const void* params, long long period,
               const void* field, int rows, int cols, int depth,
               void* e_phi, void* e_xmu, void* e_xxt, long long count, int k,
               int m, int nonneg, int rdim, int quant, int group_shift,
               int threads, void* stream) {
  QuadOperands<T> op;
  op.mu = static_cast<const T*>(mu);
  op.cov = static_cast<const T*>(cov);
  op.nodes = static_cast<const T*>(nodes);
  op.weights = static_cast<const T*>(weights);
  op.params = static_cast<const T*>(params);
  op.field = Field<T>{static_cast<const T*>(field), rows, cols, depth};
  op.e_phi = static_cast<T*>(e_phi);
  op.e_xmu = static_cast<T*>(e_xmu);
  op.e_xxt = static_cast<T*>(e_xxt);
  op.mu_sb = mu_sb;
  op.mu_sk = mu_sk;
  op.cov_sb = cov_sb;
  op.cov_sk = cov_sk;
  op.period = static_cast<unsigned>(period);
  op.count = static_cast<unsigned>(count);
  op.k = static_cast<unsigned>(k);
  op.m = m;
  op.group_shift = group_shift;
  op.nonneg = nonneg;
  op.rdim = rdim;
  op.quant = quant;
  const auto st = static_cast<cudaStream_t>(stream);
  if (cost == kRangeCost && d == 2 && np == RangeCost<1>::kParams)
    return launch_quad<T, 2, RangeCost<1>, WithMoments>(op, threads, st);
  if (cost == kRangeCost && d == 4 && np == RangeCost<2>::kParams)
    return launch_quad<T, 4, RangeCost<2>, WithMoments>(op, threads, st);
  if (cost == kRangeCost && d == 6 && np == RangeCost<3>::kParams)
    return launch_quad<T, 6, RangeCost<3>, WithMoments>(op, threads, st);
  if (cost == kSdf3dCost && d == 6 && np == Sdf3dCost::kParams &&
      field_ok<Sdf3dCost>(op.field))
    return launch_quad<T, 6, Sdf3dCost, WithMoments>(op, threads, st);
  if constexpr (Windows) {
    if (cost == kArmSdfCost)
      return d == 14 && np == ArmSdfCost::kParams &&
                     field_ok<ArmSdfCost>(op.field)
                 ? launch_quad_arm<T, WithMoments>(op, threads, st)
                 : -1;
    if (cost == kSdf3dPatchCost && d == 6 &&
        np == Sdf3dPatchCost::kParams && field_ok<Sdf3dPatchCost>(op.field))
      return launch_quad<T, 6, Sdf3dPatchCost, WithMoments>(op, threads, st);
    if (cost == kPlanarPatchCost && np == PlanarPatchCost::kParams &&
        field_ok<PlanarPatchCost>(op.field)) {
      if (d == 2)
        return launch_quad<T, 2, PlanarPatchCost, WithMoments>(op, threads,
                                                               st);
      if (d == 4)
        return launch_quad<T, 4, PlanarPatchCost, WithMoments>(op, threads,
                                                               st);
      return -1;
    }
  }
  if (cost != kPlanarSdfCost || np != PlanarSdfCost::kParams ||
      !field_ok<PlanarSdfCost>(op.field))
    return -1;
  if (d == 2)
    return launch_quad<T, 2, PlanarSdfCost, WithMoments>(op, threads, st);
  if (d == 4)
    return launch_quad<T, 4, PlanarSdfCost, WithMoments>(op, threads, st);
  return -1;
}

}  // namespace
}  // namespace gvi
