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

// One pivot recursion per half, the two at once: half 0 walks up (F_i =
// D_i + f_i, f_{i+1} = -B_i^T F_i^{-1} B_i), half 1 down (G_i = D_i + g_i,
// g_{i-1} = -B_{i-1} G_i^{-1} B_{i-1}^T), the same code on mirrored data
// (chain.cuh pivot_sweeps).  The lane carries column c of the message;
// pivots go to piv (kMat apart).  Returns the half's Kahan-compensated log
// det of its pivots, NaN-poisoned by the pivot-trust guard (the forward
// one, half 0's, is the chain's).  diag, off: the chain's blocks in device
// memory (row-major s x s).
template <typename T, int S>
__device__ __forceinline__ T wide_sweep(const T* __restrict__ diag,
                                        const T* __restrict__ off, int n,
                                        T* piv, T* lb, T* rd, T* bs,
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
      d[r] = diag[i * SS + r * S + g.c];
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
      const T* b = off + (g.half ? i - 1 : i) * SS;
      T bcol[S];
#pragma unroll
      for (int r = 0; r < S; ++r)
        bcol[r] = g.half ? b[g.c * S + r] : b[r * S + g.c];
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

// K1 at s = 14: one chain per one-warp block (see the note at the top).
template <typename T, int S>
__global__ void __launch_bounds__(kWarp)
gbp_wide_kernel(const T* __restrict__ diag, const T* __restrict__ off,
                T* __restrict__ covd, T* __restrict__ covo,
                T* __restrict__ ld_out, T* __restrict__ scratch, int n) {
  constexpr int P = Wide<S>::kCol, M = Wide<S>::kMat, SS = S * S;
  constexpr int W = Wide<S>::kGbpWork;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* work = reinterpret_cast<T*>(smem_raw);
  const HalfLanes<S> g(threadIdx.x);
  const int64_t b = blockIdx.x;
  T* fpiv = scratch == nullptr ? work + 2 * W
                               : scratch + b * gbp_wide_elems<S>(n);
  T* gpiv = fpiv + (int64_t)n * M;
  T* lb = work + g.half * W;
  T* rd = lb + M;
  T* bs = rd + Wide<S>::kVec;
  T* xs = bs + M;
  T* ss = xs + M;
  diag += b * n * SS;
  off += b * (n - 1) * SS;
  covd += b * n * SS;
  covo += b * (n - 1) * SS;

  const T ld = wide_sweep<T, S>(diag, off, n, g.half ? gpiv : fpiv, lb, rd,
                                bs, g);
  if (threadIdx.x == 0) ld_out[b] = ld;
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
    T x[S], ginv[S];
#pragma unroll
    for (int r = 0; r < S; ++r) a[r] = gpiv[(e + 1) * M + g.c * P + r];
    chol_cols(a, lb, rd, g);
    {
      T rhs[S];   // column c of B^T
#pragma unroll
      for (int r = 0; r < S; ++r) rhs[r] = bo[g.c * S + r];
      solve_cols(lb, rd, rhs, x);   // column c of X = G^{-1} B^T
    }
    if (last) solve_cols(lb, rd, ec, ginv);
    if (g.active) {
#pragma unroll
      for (int r = 0; r < S; ++r) {
        xs[g.c * P + r] = x[r];
        bs[g.c * P + r] = bo[r * S + g.c];
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

template <typename T, int S>
int launch_gbp_wide(const void* diag, const void* off, void* covd,
                    void* covo, void* ld, void* scratch, int nb, int n,
                    long long arena, cudaStream_t st) {
  if (n < 1 || arena != gbp_wide_elems<S>(n)) return -1;
  const size_t smem = sizeof(T) * (2 * Wide<S>::kGbpWork +
                                   (scratch == nullptr ? arena : 0));
  if (smem > kMaxSmem) return -1;
  static std::atomic<uint64_t> smem_allowed{0};
  const cudaError_t prep = allow_smem_once(gbp_wide_kernel<T, S>,
                                           smem_allowed);
  if (prep != cudaSuccess) return static_cast<int>(prep);
  gbp_wide_kernel<T, S><<<nb, kWarp, smem, st>>>(
      static_cast<const T*>(diag), static_cast<const T*>(off),
      static_cast<T*>(covd), static_cast<T*>(covo), static_cast<T*>(ld),
      static_cast<T*>(scratch), n);
  return static_cast<int>(cudaGetLastError());
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
