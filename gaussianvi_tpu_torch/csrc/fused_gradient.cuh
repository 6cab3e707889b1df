// The NGD gradient step of one iteration in one kernel, in three modes.
//
// Replaces the TPU kernel gaussianvi_tpu/kernels/fused_gradient.py,
// gradient_lanes (_grad_kernel, modes "full", "accum" and "solve").  Mode
// "full" computes, per problem:
//   - the forward and backward pivots of Lambda and its Kahan-compensated
//     log det, poisoned by the pivot-trust guard;
//   - per edge the 2s x 2s joint inverse: the covariance blocks (the
//     iteration's record), and from each state's marginal the sigma-point
//     moments with the marginal-rule lift, the NGD local gradients
//     Vdmu_k = P E[(x-mu)phi] / T, Vddmu_k = (sym(P E P) - P E[phi]) / T,
//     and the linear factors' closed-form gradients from the residual form
//     (Vdmu = 2 Lam^T prec_c (Lam mu - pm) / T, Vddmu = 2 A / T), summed
//     into the joint accumulators Vdmu, Vddmu (diag and off);
//   - dprec = Vddmu - Lambda;
//   - the block-Thomas solves Vddmu dmu = -Vdmu and, the SPD fallback,
//     Lambda dmu_fb = -Vdmu.
// The other two modes split that program where a factor-parallel run sums
// the partial gradients of its ranks:
//   "accum": the accumulators of the nonlinear factors it is given (one
//     rank's shard) are its outputs, without log det, covariance record,
//     dprec or solves; the caller sums them over the ranks;
//   "solve": the accumulators start from that sum (seeds, read only), the
//     linear factors (which every rank holds) are added, and everything
//     "full" returns is returned.
// The mode is a template parameter: each mode's kernel contains only its
// own phases (one .cu file per mode, so the three compile side by side).
// An indefinite Vddmu gives NaN in dmu (sqrt of a negative pivot), never a
// trap; the loop then takes dmu_fb.  Moments are unguarded, as on every
// path of the JAX package; only the log det carries the trust guard.
//
// What bounds it on the card: the latency of dependent s x s algebra.  A
// call moves a few MB and a few hundred MFLOP; the card would need
// microseconds for either.  Only the two pivot recursions and the solves'
// sweeps depend on their neighbour in the chain; everything else is
// independent per edge.  The design:
//   - a warp per problem, kGradWarps-or-fewer problems per block, so that
//     B = 1024 problems are 1024 warps over all 132 SMs;
//   - the problem's chain lives in the arena (shared memory; a global
//     scratch for a chain too long for it, same code): Lambda, mu, both
//     pivot arrays, the accumulators, the solves' right-hand sides.  Inputs
//     arrive by asynchronous copies (cp.async; Lambda first, so phase A
//     starts while the mean and the seeds are still in flight), outputs
//     leave by coalesced stores; no operand is read or written twice in
//     device memory;
//   - phase A (serial): both pivot recursions at once on different lanes,
//     the s columns of each message on s lanes (fused.cuh pivot_sweeps);
//   - phase B (parallel): lane i takes edge i: the joint inverse, the
//     state's quadrature and gradients, the edge's linear factors.  A state
//     is owned by its lane; an edge's contribution to the next state is
//     added behind a __syncwarp, after that state's own: a fixed order, no
//     atomics, the same bits on every run and on every rank;
//   - phase C: dprec elementwise over lanes, then both Thomas solves at the
//     same time, one per lane-group parity with the same code
//     (thomas_pair); each solve factors each of its pivots once and keeps
//     the factor in the arena for the back substitution.
// Where the time goes at B = 1024 (one wave of warps, so a problem's
// latency is the kernel's): the two serial sweeps of phase A and the
// solves of phase C, each step a chain of dependent s x s operations;
// phase B is one turn of the lanes.  At s = 6 (fused_gradient_s6.cuh)
// every factorization takes chol_r's Fast factor, which drops the IEEE
// square root and division from each column's chain, and phase B runs on
// lane groups (an edge on eight lanes, the quadrature's nodes over them)
// at the instances where that is faster.
#pragma once

#include "fused.cuh"

namespace gvi {

constexpr int kGradWarps = 4;   // most problems (warps) of a block

enum GradMode { kGradFull = 0, kGradAccum = 1, kGradSolve = 2 };

// Arena of one problem, in values of T: pd, po, F, G, vdd, vdo as n blocks
// each, mu, vdmu and the two solves' vectors as n vectors each
// (kernels/fused_gradient.py grad_chain_elems is the wrapper's copy).
template <int S>
__host__ __device__ constexpr int64_t grad_chain_elems(int64_t n) {
  return n * (6 * Pitch<S>::kMat + 4 * Pitch<S>::kVec);
}

// acc_block += a * scale, one s x s block of the arena.
template <typename T, int S>
__device__ __forceinline__ void accumulate(T* acc, const T (&a)[S][S],
                                           T scale) {
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c)
      acc[r * S + c] = dfma(a[r][c], scale, acc[r * S + c]);
}

// Joint gradient contributions of every nonlinear (not in mode "solve")
// and span-1 linear (not in mode "accum") factor at state i of problem b,
// marginal N(mu_c, cov).  vdmu_i / vdd_i point at state i in the arena.
// Fast: chol_r's.
template <typename T, int S, bool Fast, typename Cost, int Mode>
__device__ __forceinline__ void state_gradients(
    const Factors<T>& f, const T* rules, int n, int i,
    const T (&cov)[S][S], const T (&mu_c)[S], int64_t b, T inv_t, T* vdmu_i,
    T* vdd_i) {
  // a compile-time zero drops the loop from the mode that never runs it
  const int n_nl = Mode == kGradSolve ? 0 : f.n_nl;
  const int n_lin = Mode == kGradAccum ? 0 : f.n_lin;
  for (int j = 0; j < n_nl; ++j) {
    const NLBatch<T>& fb = f.nl[j];
    for_factors_at(fb.index, n, i, [&](int k) {
      T l[S][S], rd[S], p[Cost::kParams], e_phi, absum, e_x[S];
      T e_tri[Tri<S>::value];
      chol_r<T, S, Fast>(cov, l, rd);
      load_params<T, Cost>(fb, k, b, p);
      sigma_sums<T, S, Cost, true>(l, mu_c, p, fb.field, rules + fb.smem,
                                   rules + fb.smem + fb.m * S, fb.m, e_phi,
                                   absum, e_x, e_tri, fb.quant);
      T exx[S][S];
      int t = 0;
#pragma unroll
      for (int a = 0; a < S; ++a)
#pragma unroll
        for (int c = 0; c <= a; ++c) {
          const T v = lifted_moment(e_tri[t++], l, a, c, fb.rdim, e_phi);
          exx[a][c] = v;
          exx[c][a] = v;
        }
      T prec[S][S], pe[S][S], pep[S][S];
      inv_from_chol_r(l, rd, prec);
      // Vdmu_k = P E[(x-mu) phi] / T
      T vd[S];
#pragma unroll
      for (int r = 0; r < S; ++r) {
        T acc = vdmu_i[r];
#pragma unroll
        for (int c = 0; c < S; ++c)
          acc = dfma(prec[r][c] * e_x[c], inv_t, acc);
        vd[r] = acc;
      }
#pragma unroll
      for (int r = 0; r < S; ++r) vdmu_i[r] = vd[r];
      // Vddmu_k = (sym(P E P) - P E[phi]) / T
      matmul(prec, exx, pe);
      matmul(pe, prec, pep);
#pragma unroll
      for (int a = 0; a < S; ++a)
#pragma unroll
        for (int c = 0; c < S; ++c)
          vdd_i[a * S + c] = dfma(T(0.5) * (pep[a][c] + pep[c][a]) -
                                      prec[a][c] * e_phi,
                                  inv_t, vdd_i[a * S + c]);
    });
  }
  for (int j = 0; j < n_lin; ++j) {
    const LinBatch<T>& lb = f.lin[j];
    if (lb.span != 1) continue;
    for_factors_at(lb.index, n, i, [&](int k) {
      const int kk = min(k, lb.ka - 1);
      T res[2 * S], w[2 * S], a[S][S], vd[S];
      lin_residual<T, S, 2 * S>(lb, kk, b, mu_c, res, w);
#pragma unroll
      for (int d = 0; d < S; ++d) {
        T acc = vdmu_i[d];
#pragma unroll
        for (int rr = 0; rr < 2 * S; ++rr)
          if (rr < lb.r)
            acc = dfma(T(2) * lam_row<T, S>(lb, kk, b, rr)[d] * w[rr], inv_t,
                       acc);
        vd[d] = acc;
      }
#pragma unroll
      for (int d = 0; d < S; ++d) vdmu_i[d] = vd[d];
      load_a<T, S>(lb, kk, 0, b, a);
      accumulate(vdd_i, a, T(2) * inv_t);
    });
  }
}

// The span-2 linear factors of edge i of problem b.  Part 0 adds what
// belongs to the edge's own state and to the edge (vdmu_i, vdd_i, vdo_i);
// part 1, run behind a __syncwarp, what belongs to state i + 1, which
// another lane owns.
template <typename T, int S, int Part>
__device__ __forceinline__ void edge_gradients(
    const Factors<T>& f, int n, int i, const T (&mu_i)[S],
    const T (&mu_j)[S], int64_t b, T inv_t, T* vdmu, T* vdd, T* vdo) {
  constexpr int M = Pitch<S>::kMat, V = Pitch<S>::kVec;
  for (int j = 0; j < f.n_lin; ++j) {
    const LinBatch<T>& lb = f.lin[j];
    if (lb.span != 2) continue;
    for_factors_at(lb.index, n, i, [&](int k) {
      const int kk = min(k, lb.ka - 1);
      T mu_e[2 * S], res[2 * S], w[2 * S], vd[S], a[S][S];
#pragma unroll
      for (int r = 0; r < S; ++r) {
        mu_e[r] = mu_i[r];
        mu_e[S + r] = mu_j[r];
      }
      lin_residual<T, 2 * S, 2 * S>(lb, kk, b, mu_e, res, w);
      T* vdmu_s = vdmu + (i + Part) * V;
#pragma unroll
      for (int d = 0; d < S; ++d) {
        T acc = vdmu_s[d];
#pragma unroll
        for (int rr = 0; rr < 2 * S; ++rr)
          if (rr < lb.r)
            acc = dfma(T(2) * lam_row<T, S>(lb, kk, b, rr)[Part * S + d] *
                           w[rr],
                       inv_t, acc);
        vd[d] = acc;
      }
#pragma unroll
      for (int d = 0; d < S; ++d) vdmu_s[d] = vd[d];
      const T two_t = T(2) * inv_t;
      load_a<T, S>(lb, kk, Part, b, a);
      accumulate(vdd + (i + Part) * M, a, two_t);
      if (Part == 0) {
        load_a<T, S>(lb, kk, 2, b, a);
        accumulate(vdo + i * M, a, two_t);
      }
    });
  }
}

// Mode "accum" takes null pointers for covd .. dfb and writes vdmu, vdd,
// vdo; mode "solve" reads them (the summed partial gradients); mode "full"
// takes null pointers for them.  scratch: the arena of every block where
// the chains do not fit shared memory, else null.  Fast: the s = 6
// instances' chol_r (fused.cuh).
template <typename T, int S, bool Fast, typename Cost, int Mode>
__global__ void __launch_bounds__(kGradWarps * kWarp)
grad_kernel(const T* __restrict__ mu_g, const T* __restrict__ pd_g,
            const T* __restrict__ po_g, const T* __restrict__ temp,
            T* __restrict__ covd, T* __restrict__ covo, T* __restrict__ ld_out,
            T* __restrict__ dpd, T* __restrict__ dpo, T* __restrict__ dmu,
            T* __restrict__ dfb, T* vdmu_g, T* vdd_g, T* vdo_g,
            T* __restrict__ scratch, int nb, int n,
            const __grid_constant__ Factors<T> f) {
  constexpr int M = Pitch<S>::kMat, V = Pitch<S>::kVec, SS = S * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rules = reinterpret_cast<T*>(smem_raw);
  const int warps = blockDim.x / kWarp;
  const int64_t chain = grad_chain_elems<S>(n);
  T* arena = scratch == nullptr
                 ? rules + f.rule_elems
                 : scratch + (int64_t)blockIdx.x * warps * chain;
  load_rules<T, S>(f, rules);

  // no block-wide barrier below: a warp past the end may leave
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t b = (int64_t)blockIdx.x * warps + warp;
  if (b >= nb) return;

  T* pd = arena + warp * chain;
  T* po = pd + n * M;
  T* fpiv = po + n * M;
  T* gpiv = fpiv + n * M;
  T* vdd = gpiv + n * M;
  T* vdo = vdd + n * M;
  T* mu = vdo + n * M;
  T* vdmu = mu + n * V;
  T* x0 = vdmu + n * V;
  T* x1 = x0 + n * V;
  const int64_t mats = (int64_t)n * SS, offs = (int64_t)(n - 1) * SS;
  const int64_t vecs = (int64_t)n * S;

  // ---- load: the problem's chain, each operand read once.  Lambda comes
  // first and phase A starts on it while the mean and the seeds arrive ----
  const bool in_smem = scratch == nullptr;
  copy_in_async<T, SS>(pd, M, pd_g + b * mats, n, lane, kWarp, in_smem);
  copy_in_async<T, SS>(po, M, po_g + b * offs, n - 1, lane, kWarp, in_smem);
  async_commit();
  copy_in_async<T, S>(mu, V, mu_g + b * vecs, n, lane, kWarp, in_smem);
  if constexpr (Mode == kGradSolve) {
    copy_in_async<T, SS>(vdd, M, vdd_g + b * mats, n, lane, kWarp, in_smem);
    copy_in_async<T, SS>(vdo, M, vdo_g + b * offs, n - 1, lane, kWarp,
                         in_smem);
    copy_in_async<T, S>(vdmu, V, vdmu_g + b * vecs, n, lane, kWarp, in_smem);
  } else {
    for (int e = lane; e < n * M; e += kWarp) {
      vdd[e] = T(0);
      vdo[e] = T(0);
    }
    for (int e = lane; e < n * V; e += kWarp) vdmu[e] = T(0);
  }
  async_commit();
  const T inv_t = T(1) / temp[b];
  async_wait<1>();
  __syncwarp();

  // ---- phase A: both pivot recursions, log det --------------------------
  const ChainBlocks<T, S> lambda{pd, po};
  const T ld = pivot_sweeps<T, S, Mode != kGradAccum, Fast>(lambda, n, lane,
                                                            fpiv, gpiv);
  if constexpr (Mode != kGradAccum)
    if (lane == 0) ld_out[b] = ld;
  async_wait<0>();
  __syncwarp();

  // ---- phase B: lane = edge; chunks from the chain's end, so that a state
  // receives its own contributions before its left neighbour's ------------
  const int edges = n - 1;
  for (int base = ((edges - 1) / kWarp) * kWarp; base >= 0; base -= kWarp) {
    const int i = base + lane;
    const bool on = i < edges;
    T mu_i[S], mu_j[S];
    if (on) {
      T fp[S][S], g[S][S], bo[S][S], cii[S][S], cjj[S][S], cij[S][S];
      load_mat(fpiv + i * M, 1, fp);
      load_mat(gpiv + (i + 1) * M, 1, g);
      load_mat(po + i * M, 1, bo);
      edge_covariance_r<T, S, Fast>(fp, g, bo, cii, cjj, cij);
      if constexpr (Mode != kGradAccum) {
        // the record, staged where this lane's pivots were (no other lane
        // reads F_i or G_{i+1}): covd in fpiv, covo[i] in gpiv[i + 1]
        store_mat(fpiv + i * M, 1, cii);
        store_mat(gpiv + (i + 1) * M, 1, cij);
        if (i == edges - 1) store_mat(fpiv + (i + 1) * M, 1, cjj);
      }
#pragma unroll
      for (int r = 0; r < S; ++r) {
        mu_i[r] = mu[i * V + r];
        mu_j[r] = mu[(i + 1) * V + r];
      }
      state_gradients<T, S, Fast, Cost, Mode>(f, rules, n, i, cii, mu_i, b,
                                              inv_t, vdmu + i * V,
                                              vdd + i * M);
      if (i == edges - 1)
        state_gradients<T, S, Fast, Cost, Mode>(f, rules, n, n - 1, cjj,
                                                mu_j, b, inv_t,
                                                vdmu + (n - 1) * V,
                                                vdd + (n - 1) * M);
      if constexpr (Mode != kGradAccum)
        edge_gradients<T, S, 0>(f, n, i, mu_i, mu_j, b, inv_t, vdmu,
                                vdd, vdo);
    }
    if constexpr (Mode != kGradAccum) {
      __syncwarp();
      if (on)
        edge_gradients<T, S, 1>(f, n, i, mu_i, mu_j, b, inv_t, vdmu,
                                vdd, vdo);
    }
    __syncwarp();
  }

  // mode "accum" ends here: vdmu, vdd, vdo are its outputs
  if constexpr (Mode == kGradAccum) {
    copy_out<T, SS>(vdd_g + b * mats, vdd, M, n, lane, kWarp);
    copy_out<T, SS>(vdo_g + b * offs, vdo, M, n - 1, lane, kWarp);
    copy_out<T, S>(vdmu_g + b * vecs, vdmu, V, n, lane, kWarp);
    return;
  }

  // ---- the record out, dprec = Vddmu - Lambda ----------------------------
  copy_out<T, SS>(covd + b * mats, fpiv, M, n, lane, kWarp);
  copy_out<T, SS>(covo + b * offs, gpiv + M, M, n - 1, lane, kWarp);
  for (int e = lane; e < mats; e += kWarp) {
    const int at = (e / SS) * M + e % SS;
    dpd[b * mats + e] = vdd[at] - pd[at];
  }
  for (int e = lane; e < offs; e += kWarp) {
    const int at = (e / SS) * M + e % SS;
    dpo[b * offs + e] = vdo[at] - po[at];
  }
  __syncwarp();

  // ---- phase C: Vddmu dmu = -Vdmu and Lambda dmu_fb = -Vdmu at once -----
  thomas_pair<T, S, Fast>(vdd, vdo, pd, po, vdmu, gpiv, fpiv, x0, x1, n,
                          lane);
  copy_out<T, S>(dmu + b * vecs, x0, V, n, lane, kWarp);
  copy_out<T, S>(dfb + b * vecs, x1, V, n, lane, kWarp);
}

template <typename T, int S, typename Cost, int Mode, bool Fast = false>
int dispatch_grad(const void* mu, const void* pd, const void* po,
                  const void* temp, void* covd, void* covo, void* ld,
                  void* dpd, void* dpo, void* dmu, void* dfb, void* vdmu,
                  void* vdd, void* vdo, void* scratch, int nb, int n,
                  int warps, long long chain, int n_nl, void* const* nl_ptrs,
                  const int* nl_ints, int n_lin, void* const* lin_ptrs,
                  const int* lin_ints, cudaStream_t st) {
  Factors<T> f;
  if (!parse_factors<T, S>(n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs,
                           lin_ints, f) ||
      !fields_ok<Cost>(f))
    return -1;
  // the wrapper sized the arena: both sides must lay a chain out alike
  if (warps < 1 || warps > kGradWarps || chain != grad_chain_elems<S>(n))
    return -1;
  const size_t smem =
      smem_bytes(f, scratch == nullptr ? (size_t)warps * chain : 0);
  if (smem > kMaxSmem) return -1;
  auto kernel = grad_kernel<T, S, Fast, Cost, Mode>;
  const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (nb + warps - 1) / warps;
  kernel<<<blocks, warps * kWarp, smem, st>>>(
      static_cast<const T*>(mu), static_cast<const T*>(pd),
      static_cast<const T*>(po), static_cast<const T*>(temp),
      static_cast<T*>(covd), static_cast<T*>(covo), static_cast<T*>(ld),
      static_cast<T*>(dpd), static_cast<T*>(dpo), static_cast<T*>(dmu),
      static_cast<T*>(dfb), static_cast<T*>(vdmu), static_cast<T*>(vdd),
      static_cast<T*>(vdo), static_cast<T*>(scratch), nb, n, f);
  return static_cast<int>(cudaGetLastError());
}

// s = 6 (the 3-D planners, chain estimation at dim_x = 3) with the range
// and the 3-D SDF cost, and in modes "full" and "accum" the 3-D SDF's
// patch mode, float32 and float64, one function a mode, each in a
// translation unit of its own (fused_gradient_s6.cu, fused_gradient_accum_s6.cu,
// fused_gradient_solve_s6.cu): their instances take nvcc longer than the
// rest of the library, so that the build compiles them beside the others.
// Arguments and result as launch_grad's.
#define GVI_GRAD_S6_PARAMS                                                    \
  int dtype, int cost, int np, const void *mu, const void *pd,              \
      const void *po, const void *temp, void *covd, void *covo, void *ld,   \
      void *dpd, void *dpo, void *dmu, void *dfb, void *vdmu, void *vdd,    \
      void *vdo, void *scratch, int nb, int n, int warps, long long chain,  \
      int n_nl, void *const *nl_ptrs, const int *nl_ints, int n_lin,        \
      void *const *lin_ptrs, const int *lin_ints, cudaStream_t st
int launch_grad_full_s6(GVI_GRAD_S6_PARAMS);
int launch_grad_accum_s6(GVI_GRAD_S6_PARAMS);
int launch_grad_solve_s6(GVI_GRAD_S6_PARAMS);

// The body of launch_grad_<mode>_s6, for the translation unit that defines
// it (including fused_gradient_s6.cuh, the s = 6 layout): the (dtype,
// cost) instances of one mode.  Mode "solve" takes no
// nonlinear factor, so its two cost instances run the same code; the
// wrapper names the range cost there.  Modes "full" and "accum" also take
// the 3-D SDF's patch mode (GVI_GRAD_S6_DEFINE_WINDOWS).
#define GVI_GRAD_S6_COSTS(MODE)                                               \
  if (cost == kRangeCost) {                                                   \
    if (dtype == 0) GVI_GRAD_S6_ONE(float, RangeCost<3>, MODE)                \
    if (dtype == 1) GVI_GRAD_S6_ONE(double, RangeCost<3>, MODE)               \
  }                                                                           \
  if (cost == kSdf3dCost) {                                                   \
    if (dtype == 0) GVI_GRAD_S6_ONE(float, Sdf3dCost, MODE)                   \
    if (dtype == 1) GVI_GRAD_S6_ONE(double, Sdf3dCost, MODE)                  \
  }
#define GVI_GRAD_S6_DEFINE(NAME, MODE)                                        \
  int NAME(GVI_GRAD_S6_PARAMS) {                                              \
    GVI_GRAD_S6_COSTS(MODE)                                                   \
    return -1;                                                                \
  }
#define GVI_GRAD_S6_DEFINE_WINDOWS(NAME, MODE)                                \
  int NAME(GVI_GRAD_S6_PARAMS) {                                              \
    GVI_GRAD_S6_COSTS(MODE)                                                   \
    if (cost == kSdf3dPatchCost) {                                            \
      if (dtype == 0) GVI_GRAD_S6_ONE(float, Sdf3dPatchCost, MODE)            \
      if (dtype == 1) GVI_GRAD_S6_ONE(double, Sdf3dPatchCost, MODE)           \
    }                                                                         \
    return -1;                                                                \
  }
#define GVI_GRAD_S6_ONE(T, COST, MODE)                                        \
  {                                                                           \
    if (np != COST::kParams) return -1;                                       \
    return dispatch_grad_s6_pick<T, COST, MODE>(                              \
        mu, pd, po, temp, covd, covo, ld, dpd, dpo, dmu, dfb, vdmu, vdd, vdo, \
        scratch, nb, n, warps, chain, n_nl, nl_ptrs, nl_ints, n_lin,          \
        lin_ptrs, lin_ints, st);                                              \
  }

// One mode's instantiations (float32 / float64; s = 2 / 4 with the range
// and the planar SDF cost, and at s = 4 in modes "full" and "accum" the
// planar SDF's patch mode; s = 6 goes to the mode's launch_grad_<mode>_s6).
// dtype: 0 = float32, 1 = float64; cost: csrc/costs.cuh CostId with np
// params (one cost for every nonlinear batch; each batch brings its own
// field, null for the range cost).  warps problems per block, chain =
// grad_chain_elems values per problem, scratch = the global arena or null.  Returns the cudaError_t of
// the launch (0 = success) or -1 for sizes that are not instantiated.
template <int Mode>
int launch_grad(int dtype, int s, int cost, int np, const void* mu,
                const void* pd, const void* po, const void* temp, void* covd,
                void* covo, void* ld, void* dpd, void* dpo, void* dmu,
                void* dfb, void* vdmu, void* vdd, void* vdo, void* scratch,
                int nb, int n, int warps, long long chain, int n_nl,
                void* const* nl_ptrs, const int* nl_ints, int n_lin,
                void* const* lin_ptrs, const int* lin_ints, void* stream) {
  if (nb <= 0) return 0;
  if (n < 2) return -1;
  auto st = static_cast<cudaStream_t>(stream);
#define GVI_GRAD(T, S, COST)                                                   \
  if (np != COST::kParams) return -1;                                         \
  return dispatch_grad<T, S, COST, Mode>(                                     \
      mu, pd, po, temp, covd, covo, ld, dpd, dpo, dmu, dfb, vdmu, vdd, vdo,   \
      scratch, nb, n, warps, chain, n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs,  \
      lin_ints, st);
  if (cost == kRangeCost) {
    if (dtype == 0 && s == 2) { GVI_GRAD(float, 2, RangeCost<1>) }
    if (dtype == 0 && s == 4) { GVI_GRAD(float, 4, RangeCost<2>) }
    if (dtype == 1 && s == 2) { GVI_GRAD(double, 2, RangeCost<1>) }
    if (dtype == 1 && s == 4) { GVI_GRAD(double, 4, RangeCost<2>) }
  }
  if (cost == kPlanarSdfCost) {
    if (dtype == 0 && s == 2) { GVI_GRAD(float, 2, PlanarSdfCost) }
    if (dtype == 0 && s == 4) { GVI_GRAD(float, 4, PlanarSdfCost) }
    if (dtype == 1 && s == 2) { GVI_GRAD(double, 2, PlanarSdfCost) }
    if (dtype == 1 && s == 4) { GVI_GRAD(double, 4, PlanarSdfCost) }
  }
  if constexpr (Mode != kGradSolve) {
    if (cost == kPlanarPatchCost) {
      if (dtype == 0 && s == 4) { GVI_GRAD(float, 4, PlanarPatchCost) }
      if (dtype == 1 && s == 4) { GVI_GRAD(double, 4, PlanarPatchCost) }
    }
  }
  // s = 6: each mode's own translation unit
  if (s == 6) {
    auto s6 = Mode == kGradFull    ? launch_grad_full_s6
              : Mode == kGradAccum ? launch_grad_accum_s6
                                   : launch_grad_solve_s6;
    return s6(dtype, cost, np, mu, pd, po, temp, covd, covo, ld, dpd, dpo,
              dmu, dfb, vdmu, vdd, vdo, scratch, nb, n, warps, chain, n_nl,
              nl_ptrs, nl_ints, n_lin, lin_ptrs, lin_ints, st);
  }
#undef GVI_GRAD
  return -1;
}

}  // namespace gvi

// The C entry point of one mode: every mode takes the same arguments.
#define GVI_GRAD_ENTRY(NAME, MODE)                                             \
  extern "C" int NAME(int dtype, int s, int cost, int np, const void* mu,     \
                      const void* pd, const void* po, const void* temp,       \
                      void* covd, void* covo, void* ld, void* dpd, void* dpo, \
                      void* dmu, void* dfb, void* vdmu, void* vdd, void* vdo, \
                      void* scratch, int nb, int n, int warps,                \
                      long long chain, int n_nl, void* const* nl_ptrs,        \
                      const int* nl_ints, int n_lin, void* const* lin_ptrs,   \
                      const int* lin_ints, void* stream) {                    \
    return gvi::launch_grad<MODE>(dtype, s, cost, np, mu, pd, po, temp, covd, \
                                  covo, ld, dpd, dpo, dmu, dfb, vdmu, vdd,    \
                                  vdo, scratch, nb, n, warps, chain, n_nl,    \
                                  nl_ptrs, nl_ints, n_lin, lin_ptrs,          \
                                  lin_ints, stream);                          \
  }
