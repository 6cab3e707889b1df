// The lane-group layout of the fused gradient kernel's parallel phase at
// s = 6: at the instances where it is the faster one, K6
// (fused_gradient_s6.cuh) takes each chain edge on a group of eight lanes
// instead of one thread.
//
// At s = 6 one lane that holds an edge's six blocks (F_i, G_{i+1}, B_i and
// the three covariance blocks), the Schur form's temporaries and a whole
// quadrature rule's running sums needs all 255 registers a thread may have
// and spills (0.6-1.6 KB a thread).  Here the group's lanes share the work:
//   - lane c of the group (c = 0..5; lanes 6 and 7 repeat column 5 and
//     store nothing) holds column c of each block it forms.  Each of the
//     Schur form's two s x s factorizations is taken by every lane of the
//     group from the block in shared memory (a broadcast read; the factor
//     is 27 values), and each lane then solves for its own column, in the
//     operation order of fused.cuh edge_covariance_schur (with chol_r's
//     Fast factor, as every s = 6 instance of K6 takes it), so that
//     the covariance blocks have that function's bits.  The group publishes
//     what its lanes need whole (the Schur complement, then Sig_ii; X) in
//     the edge's own pivot slots of the arena, F_i and G_{i+1}, which no
//     other edge reads;
//   - the state's quadrature nodes are spread over the group's eight lanes
//     (lane j takes nodes j, j + 8, ...; sigma.cuh sigma_sums) and the
//     group's sums meet in an xor butterfly of fixed order, as K3's lane
//     groups do (quad.cuh): every lane ends with the same bits;
//   - a linear factor's residual rows are spread over the group's lanes
//     (lin_residual_group, two rows a lane), its closed forms taken by
//     columns, each lane its own, and summed by the same butterfly where
//     they are a scalar.
// A warp runs four edges where the lane-per-edge layout runs 32, each with
// a quarter of the dependent steps or fewer and no spills; which of the two
// wins depends on the cost's nodes and the chain's length (PERF.md, section
// 6).  A group's lanes take one branch together (their edge, their state's
// factors), so every barrier and shuffle here names the group's own mask
// and groups of one warp may run different factor counts.  No atomics, a
// fixed order: two launches give the same bits.
#pragma once

#include "fused.cuh"

namespace gvi {

constexpr int kGroup = 8;                 // lanes of an edge's group
constexpr int kGroups = kWarp / kGroup;   // groups of a warp

// A lane's group in its warp, its place there and the column it holds.
template <int S>
struct GroupLanes {
  int g, gl, c;
  bool active;       // gl < S: the lane stores its column
  unsigned mask;     // the group's lanes
  __device__ __forceinline__ explicit GroupLanes(int lane)
      : g(lane / kGroup),
        gl(lane % kGroup),
        c(min(lane % kGroup, S - 1)),
        active(lane % kGroup < S),
        mask(0xffu << (lane / kGroup * kGroup)) {}
};

// Sum over the group's eight lanes, xor butterfly (sigma.cuh group_sum's
// order under the group's mask).
template <typename T>
__device__ __forceinline__ T gsum(T v, unsigned mask) {
#pragma unroll
  for (int o = kGroup >> 1; o > 0; o >>= 1)
    v = v + __shfl_xor_sync(mask, v, o);
  return v;
}

template <typename T, int S>
__device__ __forceinline__ void unit_vec(int c, T (&e)[S]) {
#pragma unroll
  for (int r = 0; r < S; ++r) e[r] = r == c ? T(1) : T(0);
}

// The edge's coupling B_e read from the arena (row-major).
template <typename T, int S>
struct ArenaCoupling {
  const T* b;
  __device__ __forceinline__ T operator()(int r, int c) const {
    return b[r * S + c];
  }
};

// Covariance blocks of one chain edge by columns (see the note at the
// top): from F = F_i in fslot, G = G_{i+1} in gslot (arena blocks,
// row-major) and the coupling bo, lane c ends with column c of Sig_ii,
// Sig_ij and, where with_jj, Sig_jj; on return fslot holds Sig_ii and
// gslot X = G^{-1} B^T, both whole, for every lane of the group.
// edge_covariance_schur's operations in its order.  The group's lanes
// call together.
template <typename T, int S, typename Coupling>
__device__ __forceinline__ void edge_cols(T* fslot, T* gslot,
                                          const Coupling& bo, bool with_jj,
                                          const GroupLanes<S>& g,
                                          T (&cii)[S], T (&cij)[S],
                                          T (&cjj)[S]) {
  T x[S], ginv[S];
  {
    T gm[S][S], lg[S][S], rg[S], rhs[S];
    load_mat(gslot, 1, gm);
    chol_r<T, S, true>(gm, lg, rg);
#pragma unroll
    for (int r = 0; r < S; ++r) rhs[r] = bo(g.c, r);   // column c of B^T
    chol_solve_r(lg, rg, rhs, x);
    if (with_jj) {
      T e[S];
      unit_vec(g.c, e);
      chol_solve_r(lg, rg, e, ginv);
    }
  }
  T p[S];   // column c of the Schur complement F - B X
#pragma unroll
  for (int a = 0; a < S; ++a) {
    T acc = fslot[a * S + g.c];
#pragma unroll
    for (int k = 0; k < S; ++k) acc = acc - bo(a, k) * x[k];
    p[a] = acc;
  }
  __syncwarp(g.mask);   // G and F's columns are read
  if (g.active) {
#pragma unroll
    for (int r = 0; r < S; ++r) {
      gslot[r * S + g.c] = x[r];
      fslot[r * S + g.c] = p[r];
    }
  }
  __syncwarp(g.mask);
  {
    T pm[S][S], lp[S][S], rp[S], e[S];
    load_mat(fslot, 1, pm);
    chol_r<T, S, true>(pm, lp, rp);
    unit_vec(g.c, e);
    chol_solve_r(lp, rp, e, cii);   // column c of Sig_ii
  }
  __syncwarp(g.mask);   // the Schur complement is read
  if (g.active) {
#pragma unroll
    for (int r = 0; r < S; ++r) fslot[r * S + g.c] = cii[r];
  }
  __syncwarp(g.mask);
  // column c of Sig_ij = -Sig_ii X^T
#pragma unroll
  for (int a = 0; a < S; ++a) {
    T acc = fslot[a * S] * gslot[g.c * S];
#pragma unroll
    for (int k = 1; k < S; ++k) acc = acc + fslot[a * S + k] * gslot[g.c * S + k];
    cij[a] = -acc;
  }
  if (with_jj) {   // column c of Sig_jj = G^{-1} - X Sig_ij
#pragma unroll
    for (int a = 0; a < S; ++a) {
      T acc = ginv[a];
#pragma unroll
      for (int k = 0; k < S; ++k) acc = acc - gslot[a * S + k] * cij[k];
      cjj[a] = acc;
    }
  }
}

// fused.cuh lin_residual by the group: the residual rows res = Lam mu - pm
// and the weighted rows w = prec_c res of row kk of problem b of a linear
// batch (DE = span * S values a row), each row summed as lin_residual sums
// it; lane j forms rows j and j + 8 and the group's shuffles leave every
// lane with all of res and w (rows beyond r are zero).
template <typename T, int DE, int MaxR, int S>
__device__ __forceinline__ void lin_residual_group(const LinBatch<T>& lb,
                                                   int kk, int64_t b,
                                                   const T (&mu)[DE],
                                                   const GroupLanes<S>& g,
                                                   T (&res)[MaxR],
                                                   T (&w)[MaxR]) {
  static_assert(MaxR <= 2 * kGroup, "two rows a lane");
  const int64_t row0 = (b * lb.ka + kk) * lb.r;
  const int first = g.g * kGroup;
  T mine[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int rr = g.gl + q * kGroup;
    mine[q] = T(0);
    if (rr < lb.r && rr < MaxR) {
      const int64_t row = row0 + rr;
      T acc = -lb.pm[row];
#pragma unroll
      for (int d = 0; d < DE; ++d) acc = acc + lb.lam[row * DE + d] * mu[d];
      mine[q] = acc;
    }
  }
#pragma unroll
  for (int rr = 0; rr < MaxR; ++rr)
    res[rr] = __shfl_sync(g.mask, mine[rr / kGroup], first + rr % kGroup);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int rr = g.gl + q * kGroup;
    mine[q] = T(0);
    if (rr < lb.r && rr < MaxR) {
      const T* prow = lb.prec + (row0 + rr) * lb.r;
      T acc = prow[0] * res[0];
#pragma unroll
      for (int cc = 1; cc < MaxR; ++cc)
        if (cc < lb.r) acc = acc + prow[cc] * res[cc];
      mine[q] = acc;
    }
  }
#pragma unroll
  for (int rr = 0; rr < MaxR; ++rr)
    w[rr] = __shfl_sync(g.mask, mine[rr / kGroup], first + rr % kGroup);
}

// Publish the lane's column in a row-major arena block (active lanes).
template <typename T, int S>
__device__ __forceinline__ void store_col(T* dst, const T (&col)[S],
                                          const GroupLanes<S>& g) {
  if (g.active) {
#pragma unroll
    for (int r = 0; r < S; ++r) dst[r * S + g.c] = col[r];
  }
}

}  // namespace gvi
