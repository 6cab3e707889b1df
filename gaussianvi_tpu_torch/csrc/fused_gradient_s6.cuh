// The fused NGD gradient kernel K6 at s = 6 (the 3-D planners, chain
// estimation at dim_x = 3), all three modes: the body of the translation
// units fused_gradient_s6.cu, fused_gradient_accum_s6.cu and
// fused_gradient_solve_s6.cu, to which fused_gradient.cuh launch_grad sends
// this block size.
//
// Each instance runs one of two layouts (GradS6Groups below), both with
// chol_r's Fast factor (fused.cuh) in every factorization, both computing
// what grad_kernel computes (fused_gradient.cuh: the note there says what
// each mode returns) and replacing the same TPU kernel
// (gaussianvi_tpu/kernels/fused_gradient.py _grad_kernel):
//   - grad_kernel itself, a warp per problem and a lane per edge: at s = 6
//     that lane holds the Schur form's six blocks and the state's
//     quadrature with its 28 running moment sums (255 registers, 0.5-1.4 KB
//     spilled a thread in float64), but the whole chain's edges take one
//     turn;
//   - grad_s6_kernel below, still a warp per problem with phases A and C
//     as grad_kernel's: phase B takes four edges at a time, one on each
//     group of eight lanes (fused_s6.cuh edge_cols: a column of each block
//     a lane, Sig_ii staged in F_i's slot and X, then Sig_ij, in
//     G_{i+1}'s, as grad_kernel stages the record), chunks from the
//     chain's end, so that, as in grad_kernel, a state receives its own
//     contributions before its left edge's (a __syncwarp between an edge's
//     two parts).  A state's moments spread the rule's nodes over the
//     group's lanes (sigma_sums with a stride of eight, then the group's
//     butterfly); each lane then forms column c of the NGD block: prec e_c
//     and prec E prec e_c by solves with the marginal's factor, P y =
//     L^-T L^-1 y, and the transposed column for sym() through the group's
//     slot of a work area (S x (S + 1) values a group, after the arenas in
//     shared memory).  The linear factors' rows spread over the lanes, their
//     gradients by columns, lane c its own entry of Vdmu and column of each
//     Vddmu block, in grad_kernel's order.
// The lane groups win where the quadrature is dear (the 3-D SDF's 25
// nodes, its patch functor) or where there is none (mode "solve"); the
// lane per edge where a cheap cost meets a long chain (the range cost at
// N = 32: eight turns of four edges against one of 31).  "accum" and
// "full" of one (dtype, cost) run one layout and share its code, so
// "accum" + "solve" still give "full"'s bits.
#pragma once

#include "fused_gradient.cuh"
#include "fused_s6.cuh"

namespace gvi {

// Work area of one warp (four groups), in values of T
// (kernels/fused_gradient.py grad_work_elems is the wrapper's copy).
template <int S>
__host__ __device__ constexpr int64_t grad_s6_work_elems() {
  return kGroups * S * (S + 1);
}

// Joint gradient contributions of every nonlinear (not in mode "solve")
// and span-1 linear (not in mode "accum") factor at state i of problem b,
// marginal N(mu_c, cov) with cov whole in the arena (row-major).  vdmu_i /
// vdd_i point at state i in the arena; lane c adds entry c of vdmu_i and
// column c of vdd_i.  work: the group's S x (S + 1) values.
template <typename T, int S, typename Cost, int Mode>
__device__ __forceinline__ void state_gradients_group(
    const Factors<T>& f, const T* rules, int n, int i, const T* cov_s,
    const T (&mu_c)[S], int64_t b, T inv_t, T* vdmu_i, T* vdd_i, T* work,
    const GroupLanes<S>& g) {
  constexpr int P = S + 1;
  const int n_nl = Mode == kGradSolve ? 0 : f.n_nl;
  const int n_lin = Mode == kGradAccum ? 0 : f.n_lin;
  for (int j = 0; j < n_nl; ++j) {
    const NLBatch<T>& fb = f.nl[j];
    for_factors_at(fb.index, n, i, [&](int k) {
      T cov[S][S], l[S][S], rd[S], p[Cost::kParams], e_phi, absum, e_x[S];
      T e_tri[Tri<S>::value];
      load_mat(cov_s, 1, cov);
      chol_r<T, S, true>(cov, l, rd);
      load_params<T, Cost>(fb, k, b, p);
      sigma_sums<T, S, Cost, true>(l, mu_c, p, fb.field, rules + fb.smem,
                                   rules + fb.smem + fb.m * S, fb.m, e_phi,
                                   absum, e_x, e_tri, fb.quant, g.gl, kGroup);
      e_phi = gsum(e_phi, g.mask);
#pragma unroll
      for (int a = 0; a < S; ++a) e_x[a] = gsum(e_x[a], g.mask);
#pragma unroll
      for (int t = 0; t < Tri<S>::value; ++t) e_tri[t] = gsum(e_tri[t], g.mask);
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
      // column c of prec = Sig^{-1}, and of prec E prec
      T pc[S], ep[S], pep[S];
      {
        T e[S];
        unit_vec(g.c, e);
        chol_solve_r(l, rd, e, pc);
      }
#pragma unroll
      for (int a = 0; a < S; ++a) {
        T acc = exx[a][0] * pc[0];
#pragma unroll
        for (int k2 = 1; k2 < S; ++k2) acc = acc + exx[a][k2] * pc[k2];
        ep[a] = acc;
      }
      chol_solve_r(l, rd, ep, pep);
      if (g.active) {
        // Vdmu_k = P E[(x-mu) phi] / T: entry c from row c of P (its
        // column c, P being symmetric)
        T acc = vdmu_i[g.c];
#pragma unroll
        for (int cc = 0; cc < S; ++cc)
          acc = dfma(pc[cc] * e_x[cc], inv_t, acc);
        vdmu_i[g.c] = acc;
#pragma unroll
        for (int r = 0; r < S; ++r) work[g.c * P + r] = pep[r];
      }
      __syncwarp(g.mask);
      // Vddmu_k = (sym(P E P) - P E[phi]) / T, column c
      if (g.active) {
#pragma unroll
        for (int a = 0; a < S; ++a)
          vdd_i[a * S + g.c] =
              dfma(T(0.5) * (pep[a] + work[a * P + g.c]) - pc[a] * e_phi,
                   inv_t, vdd_i[a * S + g.c]);
      }
      __syncwarp(g.mask);   // the next factor reuses the work area
    });
  }
  for (int j = 0; j < n_lin; ++j) {
    const LinBatch<T>& lb = f.lin[j];
    if (lb.span != 1) continue;
    for_factors_at(lb.index, n, i, [&](int k) {
      const int kk = min(k, lb.ka - 1);
      T res[2 * S], w[2 * S];
      lin_residual_group<T, S, 2 * S>(lb, kk, b, mu_c, g, res, w);
      if (g.active) {
        T acc = vdmu_i[g.c];
#pragma unroll
        for (int rr = 0; rr < 2 * S; ++rr)
          if (rr < lb.r)
            acc = dfma(T(2) * lam_row<T, S>(lb, kk, b, rr)[g.c] * w[rr],
                       inv_t, acc);
        vdmu_i[g.c] = acc;
        const T* a = lb.a + (b * lb.ka + kk) * S * S;
        const T two_t = T(2) * inv_t;
#pragma unroll
        for (int r = 0; r < S; ++r)
          vdd_i[r * S + g.c] = dfma(a[r * S + g.c], two_t, vdd_i[r * S + g.c]);
      }
    });
  }
}

// The span-2 linear factors of edge i of problem b, by columns (as
// fused_gradient.cuh edge_gradients, lane c its own entries).  Part 0 adds
// what belongs to the edge's own state and to the edge; part 1, run behind
// a __syncwarp, what belongs to state i + 1, which another group owns.
template <typename T, int S, int Part>
__device__ __forceinline__ void edge_gradients_group(
    const Factors<T>& f, int n, int i, const T (&mu_i)[S],
    const T (&mu_j)[S], int64_t b, T inv_t, T* vdmu, T* vdd, T* vdo,
    const GroupLanes<S>& g) {
  constexpr int M = Pitch<S>::kMat, V = Pitch<S>::kVec, SS = S * S;
  for (int j = 0; j < f.n_lin; ++j) {
    const LinBatch<T>& lb = f.lin[j];
    if (lb.span != 2) continue;
    for_factors_at(lb.index, n, i, [&](int k) {
      const int kk = min(k, lb.ka - 1);
      T mu_e[2 * S], res[2 * S], w[2 * S];
#pragma unroll
      for (int r = 0; r < S; ++r) {
        mu_e[r] = mu_i[r];
        mu_e[S + r] = mu_j[r];
      }
      lin_residual_group<T, 2 * S, 2 * S>(lb, kk, b, mu_e, g, res, w);
      if (!g.active) return;
      T* vdmu_s = vdmu + (i + Part) * V;
      T acc = vdmu_s[g.c];
#pragma unroll
      for (int rr = 0; rr < 2 * S; ++rr)
        if (rr < lb.r)
          acc = dfma(T(2) * lam_row<T, S>(lb, kk, b, rr)[Part * S + g.c] *
                         w[rr],
                     inv_t, acc);
      vdmu_s[g.c] = acc;
      const T two_t = T(2) * inv_t;
      const T* a = lb.a + (b * lb.ka + kk) * 3 * SS;
      T* dst = vdd + (i + Part) * M;
#pragma unroll
      for (int r = 0; r < S; ++r)
        dst[r * S + g.c] = dfma(a[Part * SS + r * S + g.c], two_t,
                                dst[r * S + g.c]);
      if (Part == 0) {
        T* off = vdo + i * M;
#pragma unroll
        for (int r = 0; r < S; ++r)
          off[r * S + g.c] = dfma(a[2 * SS + r * S + g.c], two_t,
                                  off[r * S + g.c]);
      }
    });
  }
}

// grad_kernel's arguments; the block's work areas follow its arenas in
// shared memory (or the rules, where the arenas are global).
template <typename T, typename Cost, int Mode>
__global__ void __launch_bounds__(kGradWarps * kWarp)
grad_s6_kernel(const T* __restrict__ mu_g, const T* __restrict__ pd_g,
               const T* __restrict__ po_g, const T* __restrict__ temp,
               T* __restrict__ covd, T* __restrict__ covo,
               T* __restrict__ ld_out, T* __restrict__ dpd,
               T* __restrict__ dpo, T* __restrict__ dmu,
               T* __restrict__ dfb, T* vdmu_g, T* vdd_g, T* vdo_g,
               T* __restrict__ scratch, int nb, int n,
               const __grid_constant__ Factors<T> f) {
  constexpr int S = 6, M = Pitch<S>::kMat, V = Pitch<S>::kVec, SS = S * S;
  constexpr int W = grad_s6_work_elems<S>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rules = reinterpret_cast<T*>(smem_raw);
  const int warps = blockDim.x / kWarp;
  const int64_t chain = grad_chain_elems<S>(n);
  const bool in_smem = scratch == nullptr;
  T* arena = in_smem ? rules + f.rule_elems
                     : scratch + (int64_t)blockIdx.x * warps * chain;
  T* works = rules + f.rule_elems + (in_smem ? warps * chain : 0);
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

  // ---- load: as grad_kernel's --------------------------------------------
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
  const T ld = pivot_sweeps<T, S, Mode != kGradAccum, true>(lambda, n, lane,
                                                            fpiv, gpiv);
  if constexpr (Mode != kGradAccum)
    if (lane == 0) ld_out[b] = ld;
  async_wait<0>();
  __syncwarp();

  // ---- phase B: an edge a group; chunks from the chain's end, so that a
  // state receives its own contributions before its left neighbour's ------
  const GroupLanes<S> g(lane);
  T* work = works + warp * W + g.g * (W / kGroups);
  const int edges = n - 1;
  for (int base = ((edges - 1) / kGroups) * kGroups; base >= 0;
       base -= kGroups) {
    const int i = base + g.g;
    const bool on = i < edges;
    T mu_i[S], mu_j[S];
    if (on) {
      const bool last = i == edges - 1;
      T* fslot = fpiv + i * M;
      T* gslot = gpiv + (i + 1) * M;
      T cii[S], cij[S], cjj[S];
      edge_cols<T, S>(fslot, gslot, ArenaCoupling<T, S>{po + i * M}, last,
                      g, cii, cij, cjj);
      // the record where grad_kernel stages it: covd in fpiv (Sig_ii is
      // there), covo[i] in gpiv[i + 1], the last Sig_jj in fpiv[n - 1]
      __syncwarp(g.mask);   // X is read
      if constexpr (Mode != kGradAccum) store_col(gslot, cij, g);
      if (last) store_col(fpiv + (i + 1) * M, cjj, g);
      __syncwarp(g.mask);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        mu_i[r] = mu[i * V + r];
        mu_j[r] = mu[(i + 1) * V + r];
      }
      state_gradients_group<T, S, Cost, Mode>(f, rules, n, i, fslot, mu_i, b,
                                              inv_t, vdmu + i * V,
                                              vdd + i * M, work, g);
      if (last)
        state_gradients_group<T, S, Cost, Mode>(
            f, rules, n, n - 1, fpiv + (n - 1) * M, mu_j, b, inv_t,
            vdmu + (n - 1) * V, vdd + (n - 1) * M, work, g);
      if constexpr (Mode != kGradAccum)
        edge_gradients_group<T, S, 0>(f, n, i, mu_i, mu_j, b, inv_t, vdmu,
                                      vdd, vdo, g);
    }
    if constexpr (Mode != kGradAccum) {
      __syncwarp();
      if (on)
        edge_gradients_group<T, S, 1>(f, n, i, mu_i, mu_j, b, inv_t, vdmu,
                                      vdd, vdo, g);
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
  thomas_pair<T, S, true>(vdd, vdo, pd, po, vdmu, gpiv, fpiv, x0, x1, n,
                          lane);
  copy_out<T, S>(dmu + b * vecs, x0, V, n, lane, kWarp);
  copy_out<T, S>(dfb + b * vecs, x1, V, n, lane, kWarp);
}

template <typename T, typename Cost, int Mode>
int dispatch_grad_s6(const void* mu, const void* pd, const void* po,
                     const void* temp, void* covd, void* covo, void* ld,
                     void* dpd, void* dpo, void* dmu, void* dfb, void* vdmu,
                     void* vdd, void* vdo, void* scratch, int nb, int n,
                     int warps, long long chain, int n_nl,
                     void* const* nl_ptrs, const int* nl_ints, int n_lin,
                     void* const* lin_ptrs, const int* lin_ints,
                     cudaStream_t st) {
  Factors<T> f;
  if (!parse_factors<T, 6>(n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs,
                           lin_ints, f) ||
      !fields_ok<Cost>(f))
    return -1;
  // the wrapper sized the arena: both sides must lay a chain out alike
  if (warps < 1 || warps > kGradWarps || chain != grad_chain_elems<6>(n))
    return -1;
  const size_t smem = smem_bytes(
      f, (scratch == nullptr ? (size_t)warps * chain : 0) +
             (size_t)warps * grad_s6_work_elems<6>());
  if (smem > kMaxSmem) return -1;
  auto kernel = grad_s6_kernel<T, Cost, Mode>;
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

// Which layout an instance runs: the lane groups above, or grad_kernel
// (fused_gradient.cuh: an edge on one lane) with chol_r's Fast factor,
// whichever was faster at the instance's model in the interleaved timing
// of PERF.md, section 6 (kernels/fused_gradient.py GRAD_S6_GROUPS is the
// wrapper's copy: the work areas of its block plan follow the layout).
// Modes "full" and "accum" of one (dtype, cost) take the same layout, so
// that "accum" + "solve" keep "full"'s bits (the layouts sum a state's
// quadrature in different orders): the 3-D SDF in float64 stays on the
// lane per edge, where both modes are faster than before, though the
// groups alone would make "full" faster still and "accum" slower.  Mode
// "solve" runs the range cost's instance whatever the model, and no
// quadrature.
template <typename T, typename Cost, int Mode>
struct GradS6Groups {
  static constexpr bool value = false;
};
#define GVI_GRAD_S6_GROUPS(T, COST, MODE)                                     \
  template <>                                                                 \
  struct GradS6Groups<T, COST, MODE> {                                        \
    static constexpr bool value = true;                                       \
  };
GVI_GRAD_S6_GROUPS(float, Sdf3dPatchCost, kGradFull)
GVI_GRAD_S6_GROUPS(double, Sdf3dPatchCost, kGradFull)
GVI_GRAD_S6_GROUPS(float, Sdf3dPatchCost, kGradAccum)
GVI_GRAD_S6_GROUPS(double, Sdf3dPatchCost, kGradAccum)
GVI_GRAD_S6_GROUPS(float, Sdf3dCost, kGradFull)
GVI_GRAD_S6_GROUPS(float, Sdf3dCost, kGradAccum)
GVI_GRAD_S6_GROUPS(float, RangeCost<3>, kGradSolve)
GVI_GRAD_S6_GROUPS(double, RangeCost<3>, kGradSolve)
#undef GVI_GRAD_S6_GROUPS

template <typename T, typename Cost, int Mode>
int dispatch_grad_s6_pick(const void* mu, const void* pd, const void* po,
                          const void* temp, void* covd, void* covo, void* ld,
                          void* dpd, void* dpo, void* dmu, void* dfb,
                          void* vdmu, void* vdd, void* vdo, void* scratch,
                          int nb, int n, int warps, long long chain, int n_nl,
                          void* const* nl_ptrs, const int* nl_ints, int n_lin,
                          void* const* lin_ptrs, const int* lin_ints,
                          cudaStream_t st) {
  if constexpr (GradS6Groups<T, Cost, Mode>::value)
    return dispatch_grad_s6<T, Cost, Mode>(
        mu, pd, po, temp, covd, covo, ld, dpd, dpo, dmu, dfb, vdmu, vdd, vdo,
        scratch, nb, n, warps, chain, n_nl, nl_ptrs, nl_ints, n_lin,
        lin_ptrs, lin_ints, st);
  else
    return dispatch_grad<T, 6, Cost, Mode, true>(
        mu, pd, po, temp, covd, covo, ld, dpd, dpo, dmu, dfb, vdmu, vdd, vdo,
        scratch, nb, n, warps, chain, n_nl, nl_ptrs, nl_ints, n_lin,
        lin_ptrs, lin_ints, st);
}

}  // namespace gvi
