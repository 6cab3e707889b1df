// Chain kernels K1 and K2 at s = 1 (the Barfoot 1-D example) and s = 14
// (the 7-DOF arm planner): chain.cu's entry points send these block sizes
// here.  A translation unit of its own, so that the unrolled s = 14 algebra
// compiles beside the other instances and not after them.
//
// s = 1 runs chain.cuh's kernels as they are: 2 lanes a chain (K1) or a
// pair (K2), 16 a warp.
//
// s = 14 replaces the same TPU kernels (gaussianvi_tpu/kernels/
// chain_lanes.py _gbp_kernel, _solve_kernel) with another layout.  At s = 6
// every lane of a lane group holds whole s x s blocks (chain.cuh: a pivot,
// its factor, the message, the coupling; the edge's Schur form in one lane)
// and needs 164-255 registers; at s = 14 one block is 196 values, so here
// no lane holds a block.  A warp carries one chain (K1) or one pair of
// systems (K2), a half warp (16 lanes) each recursion or system, and a
// lane one column (lanes 14 and 15 of a half repeat column 13 and store
// nothing):
//   - a pivot is factored across the half's lanes by columns (chol_cols:
//     at step k lane k scales its column, publishes it in shared memory,
//     and the later columns take its update), its factor read back by
//     every lane at the same address (a broadcast) for the triangular
//     solves, each lane against its own column (solve_cols);
//   - K1: half 0 runs the forward pivot recursion, half 1 the backward one,
//     at the same time; each lane carries its column of the message; the
//     pivots go to the arena.  Then the edges, two at a time, one a half,
//     in the Schur form of fused.cuh edge_covariance_schur (X = G^-1 B^T,
//     Sig_ii = (F - B X)^-1, Sig_ij = -Sig_ii X^T, the last Sig_jj = G^-1
//     - X Sig_ij), every product a lane's column against a broadcast
//     block.  N = 1: the inverse of the one block;
//   - K2: half 0 solves system 0, half 1 system 1 (thomas_wide), the
//     pivots' factors kept in the arena for the back substitution; the
//     right-hand side's vector steps run on every lane of the half alike.
// Every sum runs in the order of the s <= 6 kernels (chol_r, chol_solve_r,
// message, edge_covariance_schur, thomas), so kernel and plain versions
// differ by rounding.  What bounds it: a chain's serial depth, now 14
// dependent column steps per factorization with a warp barrier each.
// The arena: the pivots of both recursions (K1; 2 N blocks) or the factors
// and vectors of both systems (K2), in shared memory after a fixed work
// area (the staged coupling, the factor being used, X and Sig_ii of an
// edge), or in a global scratch for a chain too long for it; the work area
// stays in shared memory.  No atomics and a fixed order: the same bits on
// every launch.
//
// K1's trial form (gvi_gbp_trials; gbp_wide_kernel<.., true>) runs the
// NGD step's batched line search where no fused kernel covers the chain
// (the arm): T x B chains from the iterate's blocks, the step's and the T
// steps, each trial's precision formed element by element as the sweeps
// and edges read it (wide_elem, wide_diag: the [T, B, N, s, s] batch never
// exists, and a problem's blocks serve its T trials from L2), then, after
// the edges, each linear factor's residual-form cost from the covariance
// blocks the warp has written, a half warp a factor (wide_linear_costs).
// On 11 x 1024 chains of N = 10 (H100, f32) it takes ~1.41 ms where K1
// alone takes ~1.04 ms on the formed batch: ~0.11 ms the forming (four
// reads and three roundings a diagonal element), ~0.27 ms the costs.
#include "chain.cuh"

namespace gvi {

// Shared-memory blocks of the wide layout: column-major, columns S + 1
// apart, so the lanes of a half, a column each, fall on different banks.
template <int S>
struct Wide {
  static constexpr int kCol = S + 1;
  static constexpr int kMat = S * kCol;
  static constexpr int kVec = S + 1;
  // K1's work area of a half: factor, reciprocals, coupling, X, Sig_ii
  static constexpr int kGbpWork = 4 * kMat + kVec;
  // K2's: the staged coupling
  static constexpr int kSolveWork = kMat;
};

// Arena of one K1 warp (kernels/chain.py gbp_warp_elems): F and G, N
// blocks each.
template <int S>
__host__ __device__ constexpr int64_t gbp_wide_elems(int64_t n) {
  return 2 * n * Wide<S>::kMat;
}

// Arena of one K2 warp (kernels/chain.py solve_warp_elems): per system the
// pivots' factors, their reciprocal diagonals and the eliminated
// right-hand side, N of each.
template <int S>
__host__ __device__ constexpr int64_t solve_wide_elems(int64_t n) {
  return 2 * n * (Wide<S>::kMat + 2 * Wide<S>::kVec);
}

// A lane's half of the warp and its column there.
template <int S>
struct HalfLanes {
  int half, c;
  bool active;
  __device__ __forceinline__ explicit HalfLanes(int lane)
      : half(lane >> 4), c(min(lane & 15, S - 1)), active((lane & 15) < S) {}
};

// Cholesky factor of the SPD block whose column c the lane holds in a, by
// columns across the half's lanes: L (column-major, the diagonal as L_kk)
// and rd = 1 / diag(L) land in lb and rd, all of it published to the warp
// on return.  chol_r's operations in chol_r's
// order; a block that is not positive definite gives NaN.  Every lane of
// the warp calls, each half on its own buffers.
template <typename T, int S>
__device__ __forceinline__ void chol_cols(T (&a)[S], T* lb, T* rd,
                                          const HalfLanes<S>& g) {
  constexpr int P = Wide<S>::kCol;
  __syncwarp();   // earlier readers of lb and rd are done
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (g.c == k) {
      const T lkk = dsqrt(a[k]);
      const T inv = T(1) / lkk;
      a[k] = lkk;
#pragma unroll
      for (int r = k + 1; r < S; ++r) a[r] = a[r] * inv;
      if (g.active) {
#pragma unroll
        for (int r = k; r < S; ++r) lb[k * P + r] = a[r];
        rd[k] = inv;
      }
    }
    __syncwarp();
    if (g.c > k) {
      const T lck = lb[k * P + g.c];
#pragma unroll
      for (int r = k + 1; r < S; ++r) a[r] = a[r] - lb[k * P + r] * lck;
    }
  }
}

// x = (L L^T)^{-1} b for the lane's own b, L and rd from chol_cols (every
// lane reads the same word: a broadcast); chol_solve_r's order.
template <typename T, int S>
__device__ __forceinline__ void solve_cols(const T* lb, const T* rd,
                                           const T (&b)[S], T (&x)[S]) {
  constexpr int P = Wide<S>::kCol;
  T y[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    T acc = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - lb[k * P + i] * y[k];
    y[i] = acc * rd[i];
  }
#pragma unroll
  for (int i = S - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int k = i + 1; k < S; ++k) acc = acc - lb[i * P + k] * x[k];
    x[i] = acc * rd[i];
  }
}

// Column c of the identity.
template <typename T, int S>
__device__ __forceinline__ void unit_col(int c, T (&e)[S]) {
#pragma unroll
  for (int r = 0; r < S; ++r) e[r] = r == c ? T(1) : T(0);
}

// Column c of the message m = -(Bd^T P^{-1} Bd) from P's factor (lb, rd)
// and the directed coupling Bd staged column-major in bs, whose column c
// the lane holds in bcol (message()'s order).
template <typename T, int S>
__device__ __forceinline__ void message_col(const T* lb, const T* rd,
                                            const T* bs, const T (&bcol)[S],
                                            T (&m)[S]) {
  constexpr int P = Wide<S>::kCol;
  T x[S];
  solve_cols(lb, rd, bcol, x);
#pragma unroll
  for (int a = 0; a < S; ++a) {
    T acc = bs[a * P] * x[0];
#pragma unroll
    for (int k = 1; k < S; ++k) acc = acc + bs[a * P + k] * x[k];
    m[a] = -acc;
  }
}

// Element `at` of a chain's block: in place, or, in the trial form (K1
// over the line search's trial precisions, WideTrials), formed from the
// iterate's block x and the step's dx as the separate route forms it
// (inference/optimize.py: prec + dprec.scale(steps), no product
// contracted into a sum), and on the diagonal blocks symmetrized as it
// symmetrizes them (0.5 (x + x^T); `tr`: the transposed element), so that
// the chain's covariance and log det are K1's on the trial batch that
// route forms, bit for bit.
template <typename T, bool Trials>
__device__ __forceinline__ T wide_elem(const T* __restrict__ x,
                                       const T* __restrict__ dx, T st,
                                       int at) {
  if constexpr (Trials)
    return add_rn(x[at], mul_rn(dx[at], st));
  else
    return x[at];
}

template <typename T, bool Trials>
__device__ __forceinline__ T wide_diag(const T* __restrict__ x,
                                       const T* __restrict__ dx, T st, int at,
                                       int tr) {
  if constexpr (Trials)
    return mul_rn(T(0.5), add_rn(wide_elem<T, true>(x, dx, st, at),
                                 wide_elem<T, true>(x, dx, st, tr)));
  else
    return x[at];
}

// One pivot recursion per half, the two at once: half 0 walks up (F_i =
// D_i + f_i, f_{i+1} = -B_i^T F_i^{-1} B_i), half 1 down (G_i = D_i + g_i,
// g_{i-1} = -B_{i-1} G_i^{-1} B_{i-1}^T), the same code on mirrored data
// (chain.cuh pivot_sweeps).  The lane carries column c of the message;
// pivots go to piv (kMat apart).  Returns the half's Kahan-compensated log
// det of its pivots, NaN-poisoned by the pivot-trust guard (the forward
// one, half 0's, is the chain's).  diag, off: the chain's blocks in device
// memory (row-major s x s); the trial form's, with ddiag, doff and st
// (wide_elem, wide_diag).
template <typename T, int S, bool Trials>
__device__ __forceinline__ T wide_sweep(const T* __restrict__ diag,
                                        const T* __restrict__ off,
                                        const T* __restrict__ ddiag,
                                        const T* __restrict__ doff, T st,
                                        int n, T* piv, T* lb, T* rd, T* bs,
                                        const HalfLanes<S>& g) {
  constexpr int P = Wide<S>::kCol, M = Wide<S>::kMat, SS = S * S;
  T m[S];
#pragma unroll
  for (int r = 0; r < S; ++r) m[r] = T(0);
  T ld = T(0), comp = T(0), trust = T(1);
  for (int t = 0; t < n; ++t) {
    const int i = g.half ? n - 1 - t : t;
    T d[S], a[S];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      d[r] = wide_diag<T, Trials>(diag, ddiag, st, i * SS + r * S + g.c,
                                  i * SS + g.c * S + r);
      a[r] = d[r] + m[r];
    }
    if (g.active) {
#pragma unroll
      for (int r = 0; r < S; ++r) piv[i * M + g.c * P + r] = a[r];
    }
    T dcc = d[0], mcc = m[0], pcc = a[0];
#pragma unroll
    for (int r = 1; r < S; ++r) {
      if (r == g.c) {
        dcc = d[r];
        mcc = m[r];
        pcc = a[r];
      }
    }
    chol_cols(a, lb, rd, g);
    const T lcc = lb[g.c * P + g.c];
    const T numer = lcc * lcc;
    trust = nan_min(trust, numer / (dabs(dcc) + dabs(mcc) +
                                    dabs(pcc - numer)));
    T acc = dlog(lb[0]);
#pragma unroll
    for (int j = 1; j < S; ++j) acc = acc + dlog(lb[j * P + j]);
    kahan_add(ld, comp, T(2) * acc);
    if (t < n - 1) {
      const int at = (g.half ? i - 1 : i) * SS;
      T bcol[S];
#pragma unroll
      for (int r = 0; r < S; ++r)
        bcol[r] = wide_elem<T, Trials>(off + at, doff + at, st,
                                       g.half ? g.c * S + r : r * S + g.c);
      if (g.active) {
#pragma unroll
        for (int r = 0; r < S; ++r) bs[g.c * P + r] = bcol[r];
      }
      __syncwarp();
      message_col(lb, rd, bs, bcol, m);
    }
  }
  // the statistic's minimum over the half's lanes (NaN-propagating and
  // free of order: every lane ends with the same bits)
#pragma unroll
  for (int w = 8; w >= 1; w >>= 1)
    trust = nan_min(trust, __shfl_xor_sync(kFullMask, trust, w));
  return trust >= pivot_trust_tol<T>() ? ld : quiet_nan<T>();
}

// What K1's trial form reads beside the blocks (Trials true): chain u is
// trial t of problem b (u = b nt + t, so the nt trials of a problem run
// side by side and re-read its blocks from L2), written as chain t nb + b
// of the [nt, nb] batch; its linear factors' costs (f.lin, the residual
// form of kernels/fused_trials.py; no nonlinear batch) go to their [nt,
// nb, k] outputs (wide_linear_costs).  K1 as the wrappers call it (Trials
// false) reads none of it: chain u is block u.
template <typename T, bool Trials>
struct WideTrials {};

template <typename T>
struct WideTrials<T, true> {
  const T* mu;      // [nb, n, S]
  const T* dmu;
  const T* trials;  // [nt]
  int nb, nt;
  Factors<T> f;
};

// Cost of factor k (row kk) of linear batch lb, on Span states from state
// i, of a trial chain (the residual form, fused_trials.linear_residual_form):
//   <A, Sig_e> + (lam mu_e - pm)^T prec_c (lam mu_e - pm),
// Sig_e read back from the chain's covariance blocks (cd, co: what the
// warp has just stored, read from L2, where they are coherent), mu_e the
// trial means mu + st dmu of the factor's states, formed as the separate
// route forms them.  The half's lanes call together: lane c takes column c
// of each block (A11.Sig_ii + A22.Sig_jj + 2 A12.Sig_ij on two states,
// A.Sig_ii on one) and residual rows l and l + 16 (l its lane in the half;
// the rows through res_s, the half's own words in shared memory), and the
// half sums the lanes' parts in lane order, so every lane holds the same
// bits.  Both halves call at once, each on its own factor of the same
// batch: the warp stays converged.  Unguarded.
template <typename T, int S, int Span>
__device__ __forceinline__ T wide_linear_cost(
    const LinBatch<T>& lb, int kk, int64_t b, int i, const T* mu,
    const T* dmu, T st, const T* cd, const T* co, T* res_s,
    const HalfLanes<S>& g) {
  constexpr int SS = S * S, DE = Span * S;
  const int l = threadIdx.x & 15;
  T part = T(0);
  if (g.active) {
    const T* a = lb.a + (b * lb.ka + kk) * (Span == 2 ? 3 : 1) * SS;
    const T* sii = cd + i * SS;
    T s11 = T(0);
#pragma unroll
    for (int r = 0; r < S; ++r)
      s11 = s11 + a[r * S + g.c] * __ldcg(sii + r * S + g.c);
    part = s11;
    if constexpr (Span == 2) {
      const T* sjj = sii + SS;
      const T* sij = co + i * SS;
      T s22 = T(0), s12 = T(0);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        s22 = s22 + a[SS + r * S + g.c] * __ldcg(sjj + r * S + g.c);
        s12 = s12 + a[2 * SS + r * S + g.c] * __ldcg(sij + r * S + g.c);
      }
      part = s11 + s22 + T(2) * s12;
    }
  }
  // residual rows l and l + 16: lam mu_e - pm, then prec_c's rows against it
  const int64_t row0 = (b * lb.ka + kk) * lb.r;
  const bool h0 = l < lb.r, h1 = l + 16 < lb.r;
  const T* lam0 = lb.lam + (row0 + min(l, lb.r - 1)) * DE;
  const T* lam1 = lb.lam + (row0 + min(l + 16, lb.r - 1)) * DE;
  const T* m = mu + i * S;
  const T* dm = dmu + i * S;
  T r0 = -lb.pm[row0 + min(l, lb.r - 1)];
  T r1 = -lb.pm[row0 + min(l + 16, lb.r - 1)];
#pragma unroll
  for (int d = 0; d < DE; ++d) {
    const T me = add_rn(m[d], mul_rn(st, dm[d]));
    r0 = r0 + lam0[d] * me;
    r1 = r1 + lam1[d] * me;
  }
  r0 = h0 ? r0 : T(0);
  r1 = h1 ? r1 : T(0);
  res_s[l] = r0;
  res_s[l + 16] = r1;
  __syncwarp();
  const T* p0 = lb.prec + (row0 + min(l, lb.r - 1)) * lb.r;
  const T* p1 = lb.prec + (row0 + min(l + 16, lb.r - 1)) * lb.r;
  T w0 = T(0), w1 = T(0);
#pragma unroll
  for (int cc = 0; cc < 2 * S; ++cc) {
    if (cc < lb.r) {
      w0 = w0 + p0[cc] * res_s[cc];
      w1 = w1 + p1[cc] * res_s[cc];
    }
  }
  part = part + (r0 * w0 + r1 * w1);
  const int first = 16 * g.half;
  T total = __shfl_sync(kFullMask, part, first);
#pragma unroll
  for (int j = 1; j < 16; ++j)
    total = total + __shfl_sync(kFullMask, part, first + j);
  __syncwarp();   // res_s is free again
  return total;
}

// The trial form's epilogue: the guarded cost of every factor of every
// linear batch, two at a time, one a half (lane 0 of the half stores; on
// an odd count half 1 repeats the last and stores nothing).  The factors
// go in the order of the batch's per-state index (for_factors_at), each
// half finding its factor's state in the index's offsets.  The residual
// rows use the half's work area, free after the edges.
template <typename T, int S>
__device__ __forceinline__ void wide_linear_costs(
    const WideTrials<T, true>& tr, int64_t b, int64_t row, T st,
    const T* covd, const T* covo, int n, T* work, const HalfLanes<S>& g) {
  T* res_s = work + g.half * Wide<S>::kGbpWork;
  const T* m = tr.mu + b * n * S;
  const T* dm = tr.dmu + b * n * S;
  for (int j = 0; j < tr.f.n_lin; ++j) {
    const LinBatch<T>& lb = tr.f.lin[j];
    const int* offs = lb.index;
    const int* order = lb.index + n + 1;
    int i = 0;
    for (int q0 = 0; q0 < lb.k; q0 += 2) {
      const int q = min(q0 + g.half, lb.k - 1);
      while (offs[i + 1] <= q) ++i;
      const int k = order[q];
      const int kk = min(k, lb.ka - 1);
      const T cost =
          lb.span == 2
              ? wide_linear_cost<T, S, 2>(lb, kk, b, i, m, dm, st, covd, covo,
                                          res_s, g)
              : wide_linear_cost<T, S, 1>(lb, kk, b, i, m, dm, st, covd, covo,
                                          res_s, g);
      if ((threadIdx.x & 15) == 0 && q0 + g.half < lb.k)
        lb.fc[row * lb.k + k] = guard_linear(cost);
    }
  }
}

// K1 at s = 14: one chain per one-warp block (see the note at the top);
// the trial form (Trials): the blocks diag, off and their steps ddiag,
// doff of problem b, and `tr`.
template <typename T, int S, bool Trials>
__global__ void __launch_bounds__(kWarp)
gbp_wide_kernel(const T* __restrict__ diag, const T* __restrict__ off,
                const T* __restrict__ ddiag, const T* __restrict__ doff,
                const __grid_constant__ WideTrials<T, Trials> tr,
                T* __restrict__ covd, T* __restrict__ covo,
                T* __restrict__ ld_out, T* __restrict__ scratch, int n) {
  constexpr int P = Wide<S>::kCol, M = Wide<S>::kMat, SS = S * S;
  constexpr int W = Wide<S>::kGbpWork;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* work = reinterpret_cast<T*>(smem_raw);
  const HalfLanes<S> g(threadIdx.x);
  const int64_t u = blockIdx.x;
  int64_t b = u, row = u;   // the chain's problem, its row in the outputs
  T st = T(0);
  if constexpr (Trials) {
    const int64_t t = u % tr.nt;
    b = u / tr.nt;
    row = t * tr.nb + b;
    st = tr.trials[t];
    ddiag += b * n * SS;
    doff += b * (n - 1) * SS;
  }
  T* fpiv = scratch == nullptr ? work + 2 * W
                               : scratch + u * gbp_wide_elems<S>(n);
  T* gpiv = fpiv + (int64_t)n * M;
  T* lb = work + g.half * W;
  T* rd = lb + M;
  T* bs = rd + Wide<S>::kVec;
  T* xs = bs + M;
  T* ss = xs + M;
  diag += b * n * SS;
  off += b * (n - 1) * SS;
  covd += row * n * SS;
  covo += row * (n - 1) * SS;

  const T ld = wide_sweep<T, S, Trials>(diag, off, ddiag, doff, st, n,
                                        g.half ? gpiv : fpiv, lb, rd, bs, g);
  if (threadIdx.x == 0) ld_out[row] = ld;
  __syncwarp();   // both halves' pivots are stored

  // ---- the edges (N = 1: the one block), one a half and round; a half
  // past the last repeats it and stores nothing to device memory ---------
  const int items = n > 1 ? n - 1 : 1;
  for (int base = 0; base < items; base += 2) {
    const int e = min(base + g.half, items - 1);
    const bool out = base + g.half < items && g.active;
    T a[S], ec[S], sii[S];
    unit_col(g.c, ec);
    if (n == 1) {
#pragma unroll
      for (int r = 0; r < S; ++r) a[r] = fpiv[g.c * P + r];
      chol_cols(a, lb, rd, g);
      solve_cols(lb, rd, ec, sii);
      if (out) {
#pragma unroll
        for (int r = 0; r < S; ++r) covd[r * S + g.c] = sii[r];
      }
      continue;
    }
    const bool last = e == n - 2;
    const T* bo = off + e * SS;
    const T* dbo = doff + e * SS;
    T x[S], ginv[S];
#pragma unroll
    for (int r = 0; r < S; ++r) a[r] = gpiv[(e + 1) * M + g.c * P + r];
    chol_cols(a, lb, rd, g);
    {
      T rhs[S];   // column c of B^T
#pragma unroll
      for (int r = 0; r < S; ++r)
        rhs[r] = wide_elem<T, Trials>(bo, dbo, st, g.c * S + r);
      solve_cols(lb, rd, rhs, x);   // column c of X = G^{-1} B^T
    }
    if (last) solve_cols(lb, rd, ec, ginv);
    if (g.active) {
#pragma unroll
      for (int r = 0; r < S; ++r) {
        xs[g.c * P + r] = x[r];
        bs[g.c * P + r] = wide_elem<T, Trials>(bo, dbo, st, r * S + g.c);
      }
    }
    __syncwarp();
    // column c of the Schur complement F - B X
#pragma unroll
    for (int r = 0; r < S; ++r) {
      T acc = fpiv[e * M + g.c * P + r];
#pragma unroll
      for (int k = 0; k < S; ++k) acc = acc - bs[k * P + r] * x[k];
      a[r] = acc;
    }
    chol_cols(a, lb, rd, g);
    solve_cols(lb, rd, ec, sii);   // column c of Sig_ii
    if (g.active) {
#pragma unroll
      for (int r = 0; r < S; ++r) ss[g.c * P + r] = sii[r];
    }
    if (out) {
#pragma unroll
      for (int r = 0; r < S; ++r) covd[(e * S + r) * S + g.c] = sii[r];
    }
    __syncwarp();
    T cij[S];   // column c of Sig_ij = -Sig_ii X^T
#pragma unroll
    for (int r = 0; r < S; ++r) {
      T acc = ss[r] * xs[g.c];
#pragma unroll
      for (int k = 1; k < S; ++k) acc = acc + ss[k * P + r] * xs[k * P + g.c];
      cij[r] = -acc;
    }
    if (out) {
#pragma unroll
      for (int r = 0; r < S; ++r) covo[(e * S + r) * S + g.c] = cij[r];
    }
    if (last) {   // column c of Sig_jj = G^{-1} - X Sig_ij
#pragma unroll
      for (int r = 0; r < S; ++r) {
        T acc = ginv[r];
#pragma unroll
        for (int k = 0; k < S; ++k) acc = acc - xs[k * P + r] * cij[k];
        if (out) covd[((e + 1) * S + r) * S + g.c] = acc;
      }
    }
  }
  if constexpr (Trials) {
    __syncwarp();   // every covariance block is stored
    wide_linear_costs<T, S>(tr, b, row, st, covd, covo, n, work, g);
  }
}

// x = A^{-1} v for one block-tridiagonal system on the half's lanes
// (fused.cuh thomas's order): each pivot factored across the lanes
// (chol_cols) into lf / rdf, where it stays for the back substitution; the
// message by columns; the right-hand side's elimination and back
// substitution on every lane alike, each holding the whole vector.  y
// keeps the eliminated right-hand side (n vectors, kVec apart); the
// solution goes to xo (row-major [n, s], the lanes a value each), where
// `out`.  diag, off, v: the system in device memory.
template <typename T, int S>
__device__ __forceinline__ void thomas_wide(const T* __restrict__ diag,
                                            const T* __restrict__ off,
                                            const T* v, T* xo, bool out,
                                            T* lf, T* rdf, T* y, T* bs,
                                            int n, const HalfLanes<S>& g) {
  constexpr int P = Wide<S>::kCol, M = Wide<S>::kMat, V = Wide<S>::kVec;
  constexpr int SS = S * S;
  T m[S], yv[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    m[r] = T(0);
    yv[r] = v[r];
  }
  for (int i = 0; i < n; ++i) {
    T* lb = lf + i * M;
    T* rd = rdf + i * V;
    T a[S];
#pragma unroll
    for (int r = 0; r < S; ++r) a[r] = diag[i * SS + r * S + g.c] + m[r];
    chol_cols(a, lb, rd, g);
    if (g.active && g.c == 0) {
#pragma unroll
      for (int r = 0; r < S; ++r) y[i * V + r] = yv[r];
    }
    if (i < n - 1) {
      const T* bo = off + i * SS;
      T bcol[S], sol[S];
#pragma unroll
      for (int r = 0; r < S; ++r) bcol[r] = bo[r * S + g.c];
      if (g.active) {
#pragma unroll
        for (int r = 0; r < S; ++r) bs[g.c * P + r] = bcol[r];
      }
      __syncwarp();   // the last column and the coupling are published
      message_col(lb, rd, bs, bcol, m);
      solve_cols(lb, rd, yv, sol);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        T acc = v[(i + 1) * S + r];
#pragma unroll
        for (int k = 0; k < S; ++k) acc = acc - bs[r * P + k] * sol[k];
        yv[r] = acc;
      }
    }
  }
  __syncwarp();   // every factor and eliminated vector is published
  T xnext[S];
  for (int i = n - 1; i >= 0; --i) {
    T rhs[S], sol[S];
#pragma unroll
    for (int r = 0; r < S; ++r) rhs[r] = y[i * V + r];
    if (i < n - 1) {
      const T* bo = off + i * SS;
#pragma unroll
      for (int r = 0; r < S; ++r) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < S; ++c) acc = acc + bo[r * S + c] * xnext[c];
        rhs[r] = rhs[r] - acc;
      }
    }
    solve_cols(lf + i * M, rdf + i * V, rhs, sol);
    T mine = sol[0];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      xnext[r] = sol[r];
      if (r == g.c) mine = sol[r];
    }
    if (out && g.active) xo[i * S + g.c] = mine;
  }
}

// K2 at s = 14: pair u per one-warp block, half 0 on system 0 (d0, o0, v0
// -> x0), half 1 on system 1 (d1, o1, v1 -> x1) where u < units1, else on
// system 0 again, storing nothing.
template <typename T, int S>
__global__ void __launch_bounds__(kWarp)
solve_wide_kernel(const T* __restrict__ d0, const T* __restrict__ o0,
                  const T* v0, T* __restrict__ x0,
                  const T* __restrict__ d1, const T* __restrict__ o1,
                  const T* v1, T* __restrict__ x1,
                  T* __restrict__ scratch, int units1, int n) {
  constexpr int M = Wide<S>::kMat, V = Wide<S>::kVec, SS = S * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* work = reinterpret_cast<T*>(smem_raw);
  const HalfLanes<S> g(threadIdx.x);
  const int64_t u = blockIdx.x;
  const bool sys1 = g.half && u < units1;
  const int64_t system = (int64_t)n * (M + 2 * V);
  T* lf = (scratch == nullptr ? work + 2 * Wide<S>::kSolveWork
                              : scratch + u * solve_wide_elems<S>(n))
          + g.half * system;
  T* rdf = lf + (int64_t)n * M;
  T* y = rdf + (int64_t)n * V;
  T* bs = work + g.half * Wide<S>::kSolveWork;
  const T* d = (sys1 ? d1 : d0) + u * n * SS;
  const T* o = (sys1 ? o1 : o0) + u * (n - 1) * SS;
  const T* v = (sys1 ? v1 : v0) + u * n * S;
  T* xo = (sys1 ? x1 : x0) + u * n * S;
  thomas_wide<T, S>(d, o, v, xo, !g.half || sys1, lf, rdf, y, bs, n, g);
}

// K1 at s = 14 over `count` chains (a one-warp block each): blk the
// blocks diag, off, ddiag, doff (the last two null in place).
template <typename T, int S, bool Trials>
int launch_wide(const void* const* blk, const WideTrials<T, Trials>& tr,
                void* covd, void* covo, void* ld, void* scratch,
                int64_t count, int n, long long arena, cudaStream_t st) {
  if (n < 1 || arena != gbp_wide_elems<S>(n) || count > 0x7fffffff)
    return -1;
  const size_t smem = sizeof(T) * (2 * Wide<S>::kGbpWork +
                                   (scratch == nullptr ? arena : 0));
  if (smem > kMaxSmem) return -1;
  static std::atomic<uint64_t> smem_allowed{0};
  const cudaError_t prep = allow_smem_once(gbp_wide_kernel<T, S, Trials>,
                                           smem_allowed);
  if (prep != cudaSuccess) return static_cast<int>(prep);
  const T* const* b = reinterpret_cast<const T* const*>(blk);
  gbp_wide_kernel<T, S, Trials><<<static_cast<int>(count), kWarp, smem, st>>>(
      b[0], b[1], b[2], b[3], tr, static_cast<T*>(covd),
      static_cast<T*>(covo), static_cast<T*>(ld), static_cast<T*>(scratch),
      n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch_gbp_wide(const void* diag, const void* off, void* covd,
                    void* covo, void* ld, void* scratch, int nb, int n,
                    long long arena, cudaStream_t st) {
  const void* const blk[4] = {diag, off, nullptr, nullptr};
  return launch_wide<T, S, false>(blk, WideTrials<T, false>{}, covd, covo, ld,
                                  scratch, nb, n, arena, st);
}

// ops: pd, po, dpd, dpo, mu, dmu, trials (the trial form's).
template <typename T, int S>
int launch_gbp_trials(const void* const* ops, void* covd, void* covo,
                      void* ld, void* scratch, int nb, int nt, int n,
                      long long arena, int n_lin, void* const* lin_ptrs,
                      const int* lin_ints, cudaStream_t st) {
  WideTrials<T, true> tr;
  if (!parse_factors<T, S>(0, nullptr, nullptr, n_lin, lin_ptrs, lin_ints,
                           tr.f))
    return -1;
  for (int j = 0; j < n_lin; ++j) {
    const LinBatch<T>& lb = tr.f.lin[j];
    if (lb.span < 1 || lb.span > 2 || lb.r < 1 || lb.r > 2 * S ||
        (n == 1 && lb.span == 2 && lb.k > 0))
      return -1;
  }
  const T* const* p = reinterpret_cast<const T* const*>(ops);
  tr.mu = p[4];
  tr.dmu = p[5];
  tr.trials = p[6];
  tr.nb = nb;
  tr.nt = nt;
  const void* const blk[4] = {ops[0], ops[1], ops[2], ops[3]};
  return launch_wide<T, S, true>(blk, tr, covd, covo, ld, scratch,
                                 (int64_t)nb * nt, n, arena, st);
}

template <typename T, int S>
int launch_solve_wide(const void* const* ops, void* scratch, int units,
                      int units1, int n, long long arena, cudaStream_t st) {
  if (n < 1 || arena != solve_wide_elems<S>(n)) return -1;
  const size_t smem = sizeof(T) * (2 * Wide<S>::kSolveWork +
                                   (scratch == nullptr ? arena : 0));
  if (smem > kMaxSmem) return -1;
  static std::atomic<uint64_t> smem_allowed{0};
  const cudaError_t prep = allow_smem_once(solve_wide_kernel<T, S>,
                                           smem_allowed);
  if (prep != cudaSuccess) return static_cast<int>(prep);
  solve_wide_kernel<T, S><<<units, kWarp, smem, st>>>(
      static_cast<const T*>(ops[0]), static_cast<const T*>(ops[1]),
      static_cast<const T*>(ops[2]), static_cast<T*>(const_cast<void*>(ops[3])),
      static_cast<const T*>(ops[4]), static_cast<const T*>(ops[5]),
      static_cast<const T*>(ops[6]), static_cast<T*>(const_cast<void*>(ops[7])),
      static_cast<T*>(scratch), units1, n);
  return static_cast<int>(cudaGetLastError());
}

int launch_gbp_s1_s14(int dtype, int s, const void* diag, const void* off,
                      void* covd, void* covo, void* ld, void* scratch, int nb,
                      int n, long long arena, cudaStream_t st) {
  if (dtype == 0 && s == 1)
    return launch_gbp<float, 1>(diag, off, covd, covo, ld, scratch, nb, n,
                                arena, st);
  if (dtype == 1 && s == 1)
    return launch_gbp<double, 1>(diag, off, covd, covo, ld, scratch, nb, n,
                                 arena, st);
  if (dtype == 0 && s == 14)
    return launch_gbp_wide<float, 14>(diag, off, covd, covo, ld, scratch, nb,
                                      n, arena, st);
  if (dtype == 1 && s == 14)
    return launch_gbp_wide<double, 14>(diag, off, covd, covo, ld, scratch,
                                       nb, n, arena, st);
  return -1;
}

int launch_solve_s1_s14(int dtype, int s, const void* const* ops,
                        void* scratch, int units, int units1, int n,
                        long long arena, cudaStream_t st) {
  if (dtype == 0 && s == 1)
    return launch_solve<float, 1>(ops, scratch, units, units1, n, arena, st);
  if (dtype == 1 && s == 1)
    return launch_solve<double, 1>(ops, scratch, units, units1, n, arena, st);
  if (dtype == 0 && s == 14)
    return launch_solve_wide<float, 14>(ops, scratch, units, units1, n, arena,
                                        st);
  if (dtype == 1 && s == 14)
    return launch_solve_wide<double, 14>(ops, scratch, units, units1, n,
                                         arena, st);
  return -1;
}

}  // namespace gvi

// K1's trial form at s = 14 (gbp_wide_kernel<.., true>): ops pd, po, dpd, dpo
// (the iterate's precision and the step's direction, [nb, n, s, s] and
// [nb, n - 1, s, s]), mu, dmu ([nb, n, s]), trials [nt]; covd, covo, ld
// the [nt, nb] batch's, as gvi_gbp's; the linear batches as
// gvi_fused_trials takes them (each with its [nt, nb, k] cost output).
// Returns as gvi_gbp.
extern "C" int gvi_gbp_trials(int dtype, int s, const void* const* ops,
                              void* covd, void* covo, void* ld, void* scratch,
                              int nb, int nt, int n, long long arena,
                              int n_lin, void* const* lin_ptrs,
                              const int* lin_ints, void* stream) {
  if (nb <= 0 || nt <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && s == 14)
    return gvi::launch_gbp_trials<float, 14>(ops, covd, covo, ld, scratch,
                                             nb, nt, n, arena, n_lin,
                                             lin_ptrs, lin_ints, st);
  if (dtype == 1 && s == 14)
    return gvi::launch_gbp_trials<double, 14>(ops, covd, covo, ld, scratch,
                                              nb, nt, n, arena, n_lin,
                                              lin_ptrs, lin_ints, st);
  return -1;
}
