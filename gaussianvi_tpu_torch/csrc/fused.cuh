// Factor operands of the fused kernels (fused_trials.cu, fused_gradient.cu),
// the per-factor algebra and the warp-level chain sweeps both kernels share.
//
// A graph reaches the fused kernels as up to kMaxBatches nonlinear and
// kMaxBatches linear factor batches (gaussianvi_tpu_torch/kernels/
// fused_trials.py builds them, as gaussianvi_tpu/inference/engine.py's
// _build_fused_specs does):
//   nonlinear (nb == 1): a quadrature rule (nodes [m, S], weights [m]),
//     per-problem packed cost params [B, k, P], the cost's field (one
//     array all problems read in place; null for the range cost), and the
//     per-state index of the batch's starts (which factors sit at state i);
//   linear (span 1 or 2 states): the residual form of
//     cost = <A, Sig> + (Lam mu - pm)^T prec_c (Lam mu - pm) per row
//     (fused_trials.linear_residual_form), rows [B, ka, ...]
//     (ka == 1 for a uniform batch: every factor reads row 0).
// Every operand is problem-major, the layout PyTorch holds it in: a warp
// owns one problem and finds that problem's values side by side, so the
// wrappers pass the engine's tensors as they are.
// The C entry points take the batches as flat host arrays of pointers and
// ints (parse_factors), passed to the kernel by value as a __grid_constant__
// struct, so a kernel indexes the batches without a local copy.
//
// Shared memory of a block: the rules, then the arena (the chains of the
// block's problems; see chain_elems in each kernel).  A chain too long for
// shared memory keeps its arena in a global scratch instead: the same
// pointer arithmetic, another address space.  The per-state indices stay in
// device memory and are read through L1 (two or three ints per state and
// batch): the trial kernel's arena leaves no room for them at the flagship
// if four blocks are to share an SM.
//
// What bounds the fused kernels on the card is the latency of dependent
// s x s algebra along a chain, not bytes or operations; the design answers
// with parallelism the arithmetic allows (see pivot_sweeps below and each
// kernel's note): a warp per chain, the two pivot recursions on different
// lanes at once, a lane per edge for everything that is not serial, the
// whole chain in shared memory.  Tensor cores do not fit here: the blocks
// are 4 x 4 and 8 x 8, TF32 is off by the precision policy, and the float64
// instances are the ones the gates run on.
#pragma once

#include <cstring>

#include "sigma.cuh"

namespace gvi {

constexpr int kMaxBatches = 4;
constexpr int kNLPtrs = 6;   // nodes, weights, params, index, fc, field
// k, m, nonneg, rdim, field rows, field cols, field depth, quant
constexpr int kNLInts = 8;
constexpr int kLinPtrs = 6;  // a, lam, pm, prec, index, fc
constexpr int kLinInts = 4;  // span, k, ka, r
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
// dynamic shared memory a block may ask for on sm_90
constexpr size_t kMaxSmem = 232448;

// Arena strides: an s x s block takes S * S + 1 words and an s-vector S + 1,
// so the lanes of a warp, one block or vector each, fall on different banks.
template <int S>
struct Pitch {
  static constexpr int kMat = S * S + 1;
  static constexpr int kVec = S + 1;
};

template <typename T>
struct NLBatch {
  const T* nodes;
  const T* weights;
  const T* params;    // [B, k, P]
  const int* index;   // per-state index [n + 1 + k] (for_factors_at)
  T* fc;              // trial kernel: E[phi] out, [T, B, k]
  Field<T> field;     // the cost's field, shared by every problem
  int k, m, nonneg, rdim;
  int quant;          // 1: offsets rounded through bfloat16 (sigma.cuh)
  int smem;           // element offset of the rule in shared memory
};

template <typename T>
struct LinBatch {
  const T* a;         // [B, ka, blocks, S, S]; blocks: A, or A11 A22 A12
  const T* lam;       // [B, ka, r, span * S]
  const T* pm;        // [B, ka, r]
  const T* prec;      // [B, ka, r, r]
  const int* index;   // as NLBatch::index
  T* fc;              // trial kernel: cost out, [T, B, k]
  int span, k, ka, r;
};

template <typename T>
struct Factors {
  NLBatch<T> nl[kMaxBatches];
  LinBatch<T> lin[kMaxBatches];
  int n_nl, n_lin;
  int rule_elems;     // values of all rules (S + 1 per node)
};

// Host: fill the struct from the flat arrays; false for too many batches.
template <typename T, int S>
inline bool parse_factors(int n_nl, void* const* nl_ptrs,
                          const int* nl_ints, int n_lin,
                          void* const* lin_ptrs, const int* lin_ints,
                          Factors<T>& f) {
  if (n_nl < 0 || n_nl > kMaxBatches || n_lin < 0 || n_lin > kMaxBatches)
    return false;
  f = Factors<T>{};
  f.n_nl = n_nl;
  f.n_lin = n_lin;
  int off = 0;
  for (int j = 0; j < n_nl; ++j) {
    void* const* p = nl_ptrs + j * kNLPtrs;
    const int* q = nl_ints + j * kNLInts;
    NLBatch<T>& b = f.nl[j];
    b.nodes = static_cast<const T*>(p[0]);
    b.weights = static_cast<const T*>(p[1]);
    b.params = static_cast<const T*>(p[2]);
    b.index = static_cast<const int*>(p[3]);
    b.fc = static_cast<T*>(p[4]);
    b.field = Field<T>{static_cast<const T*>(p[5]), q[4], q[5], q[6]};
    b.k = q[0];
    b.m = q[1];
    b.nonneg = q[2];
    b.rdim = q[3];
    b.quant = q[7];
    b.smem = off;
    off += b.m * (S + 1);
  }
  for (int j = 0; j < n_lin; ++j) {
    void* const* p = lin_ptrs + j * kLinPtrs;
    const int* q = lin_ints + j * kLinInts;
    LinBatch<T>& b = f.lin[j];
    b.a = static_cast<const T*>(p[0]);
    b.lam = static_cast<const T*>(p[1]);
    b.pm = static_cast<const T*>(p[2]);
    b.prec = static_cast<const T*>(p[3]);
    b.index = static_cast<const int*>(p[4]);
    b.fc = static_cast<T*>(p[5]);
    b.span = q[0];
    b.k = q[1];
    b.ka = q[2];
    b.r = q[3];
  }
  f.rule_elems = off;
  return true;
}

// Every nonlinear batch brings the field Cost reads, where it reads one.
template <typename Cost, typename T>
inline bool fields_ok(const Factors<T>& f) {
  for (int j = 0; j < f.n_nl; ++j)
    if (!field_ok<Cost>(f.nl[j].field)) return false;
  return true;
}

// Shared memory of a launch whose arena takes arena_elems values of T there
// (0: the arena is global).
template <typename T>
inline size_t smem_bytes(const Factors<T>& f, size_t arena_elems) {
  return sizeof(T) * (f.rule_elems + arena_elems);
}

// Raise the kernel's dynamic shared memory limit where a launch needs more
// than the 48 KB every kernel may take.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

// Every thread of the block copies its share of every rule into shared
// memory, then the block meets once; nothing after this barrier is
// block-wide unless a kernel says so.
template <typename T, int S>
__device__ __forceinline__ void load_rules(const Factors<T>& f, T* rules) {
  for (int j = 0; j < f.n_nl; ++j) {
    const NLBatch<T>& b = f.nl[j];
    T* dst = rules + b.smem;
    for (int t = threadIdx.x; t < b.m * S; t += blockDim.x) dst[t] = b.nodes[t];
    for (int t = threadIdx.x; t < b.m; t += blockDim.x)
      dst[b.m * S + t] = b.weights[t];
  }
  __syncthreads();
}

// fn(k) for every factor k of a batch whose support starts at state i, in
// ascending k.  index: offsets [n + 1] into the factors ordered by state
// [k].  Every batch comes with one, a slice of states too, so that fn is
// compiled once: a rank's shard and the whole batch then run the same
// code and a factor's contribution has the same bits in either.
template <typename Fn>
__device__ __forceinline__ void for_factors_at(const int* __restrict__ index,
                                               int n, int i, Fn&& fn) {
  const int end = index[i + 1];
  for (int q = index[i]; q < end; ++q) fn(index[n + 1 + q]);
}

// Packed params of factor k of problem b.
template <typename T, typename Cost>
__device__ __forceinline__ void load_params(const NLBatch<T>& fb, int k,
                                            int64_t b,
                                            T (&p)[Cost::kParams]) {
  const T* src = fb.params + (b * fb.k + k) * Cost::kParams;
#pragma unroll
  for (int j = 0; j < Cost::kParams; ++j) p[j] = src[j];
}

// Residual rows (Lam mu - pm) of row kk of problem b of a linear batch whose
// factors span DE = span * S values, then the weighted rows w = prec_c (Lam
// mu - pm); rows beyond r (at most MaxR) are zero.  Sums in index order, as
// fused_trials._resid_cost / fused_gradient._lin_resid_w.
template <typename T, int DE, int MaxR>
__device__ __forceinline__ void lin_residual(const LinBatch<T>& lb, int kk,
                                             int64_t b, const T (&mu)[DE],
                                             T (&res)[MaxR], T (&w)[MaxR]) {
  const int64_t row0 = (b * lb.ka + kk) * lb.r;
#pragma unroll
  for (int rr = 0; rr < MaxR; ++rr) {
    res[rr] = T(0);
    if (rr < lb.r) {
      const int64_t row = row0 + rr;
      T acc = -lb.pm[row];
#pragma unroll
      for (int d = 0; d < DE; ++d) acc = acc + lb.lam[row * DE + d] * mu[d];
      res[rr] = acc;
    }
  }
#pragma unroll
  for (int rr = 0; rr < MaxR; ++rr) {
    w[rr] = T(0);
    if (rr < lb.r) {
      const T* prow = lb.prec + (row0 + rr) * lb.r;
      T acc = prow[0] * res[0];
#pragma unroll
      for (int cc = 1; cc < MaxR; ++cc)
        if (cc < lb.r) acc = acc + prow[cc] * res[cc];
      w[rr] = acc;
    }
  }
}

// Row rr of Lam of row kk of problem b: span * S values.
template <typename T, int S>
__device__ __forceinline__ const T* lam_row(const LinBatch<T>& lb, int kk,
                                            int64_t b, int rr) {
  return lb.lam + ((b * lb.ka + kk) * lb.r + rr) * (lb.span * S);
}

// Block blk (0: A or A11, 1: A22, 2: A12) of row kk of problem b of A.
template <typename T, int S>
__device__ __forceinline__ void load_a(const LinBatch<T>& lb, int kk, int blk,
                                       int64_t b, T (&a)[S][S]) {
  const int blocks = lb.span == 2 ? 3 : 1;
  load_mat(lb.a + (((b * lb.ka + kk) * blocks + blk) * S * S), 1, a);
}

// count items of Width contiguous values each: global -> arena (pitch words
// per item) and back, the threads lane, lane + lanes, ... of a warp or a
// block taking neighbouring words.
template <typename T, int Width>
__device__ __forceinline__ void copy_in(T* dst, int pitch, const T* src,
                                        int count, int lane, int lanes) {
  for (int e = lane; e < count * Width; e += lanes)
    dst[(e / Width) * pitch + e % Width] = src[e];
}

// The same copy made of asynchronous copies (cp.async, one word each: the
// arena's pitch breaks 16-byte alignment), which land in shared memory
// without passing through registers while the warp goes on; async_commit
// closes a group of them and async_wait<N> waits until at most N groups
// are in flight.  An arena in a global scratch takes the plain copy.
template <typename T, int Width>
__device__ __forceinline__ void copy_in_async(T* dst, int pitch, const T* src,
                                              int count, int lane, int lanes,
                                              bool shared) {
#if defined(__CUDACC__)
  if (shared) {
    for (int e = lane; e < count * Width; e += lanes) {
      const unsigned at = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + (e / Width) * pitch + e % Width));
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(at),
                   "l"(src + e), "n"(sizeof(T))
                   : "memory");
    }
    return;
  }
#endif
  copy_in<T, Width>(dst, pitch, src, count, lane, lanes);
}

__device__ __forceinline__ void async_commit() {
#if defined(__CUDACC__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void async_wait() {
#if defined(__CUDACC__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

template <typename T, int Width>
__device__ __forceinline__ void copy_out(T* dst, const T* src, int pitch,
                                         int count, int lane, int lanes) {
  for (int e = lane; e < count * Width; e += lanes)
    dst[e] = src[(e / Width) * pitch + e % Width];
}

// a * b + c in one rounding, spelled out where the gradient accumulators
// are summed, so that the three modes' kernels round these sums alike.
// What is left to the compiler (the residuals of the linear factors) it
// contracts per kernel: "accum" + "solve" equals "full" to rounding.
__device__ __forceinline__ float dfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double dfma(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int S>
__device__ __forceinline__ void zero_mat(T (&a)[S][S]) {
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) a[r][c] = T(0);
}

// 1 / sqrt(x): the hardware's approximation (float32, 2 ulp) or the math
// library's (float64, 1 ulp).
__device__ __forceinline__ float drsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double drsqrt(double x) { return rsqrt(x); }

// Cholesky factor with the reciprocals of its diagonal (chol forms them
// anyway).  In a chain sweep every operation waits for the one before
// it, and an IEEE division is a dozen dependent operations: the fused
// kernels divide once per pivot entry and multiply from then on.  The
// result differs from smallmat.cuh's chol_solve_vec by rounding only.
// Fast (the s = 6 instances of K5 and K6): each column takes the
// reciprocal square root of its pivot and L_jj = x / sqrt(x) from it, so
// that no IEEE square root or division waits in the column's chain; the
// factor differs from the IEEE one by a few ulps.
template <typename T, int S, bool Fast = false>
__device__ __forceinline__ void chol_r(const T (&a)[S][S], T (&l)[S][S],
                                       T (&rd)[S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    T acc = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - l[j][k] * l[j][k];
    T ljj, inv;
    if constexpr (Fast) {
      inv = drsqrt(acc);
      ljj = acc * inv;
    } else {
      ljj = dsqrt(acc);
      inv = T(1) / ljj;
    }
    l[j][j] = ljj;
    rd[j] = inv;
#pragma unroll
    for (int i = j + 1; i < S; ++i) {
      T acc2 = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc2 = acc2 - l[i][k] * l[j][k];
      l[i][j] = acc2 * inv;
    }
#pragma unroll
    for (int i = 0; i < j; ++i) l[i][j] = T(0);
  }
}

// Solve (L L^T) x = b for one vector, rd = 1 / diag(L).
template <typename T, int S>
__device__ __forceinline__ void chol_solve_r(const T (&l)[S][S],
                                             const T (&rd)[S],
                                             const T (&b)[S], T (&x)[S]) {
  T y[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    T acc = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - l[i][k] * y[k];
    y[i] = acc * rd[i];
  }
#pragma unroll
  for (int i = S - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int k = i + 1; k < S; ++k) acc = acc - l[k][i] * x[k];
    x[i] = acc * rd[i];
  }
}

// Full inverse of an SPD matrix from its factor, column by column.
template <typename T, int S>
__device__ __forceinline__ void inv_from_chol_r(const T (&l)[S][S],
                                                const T (&rd)[S],
                                                T (&inv)[S][S]) {
#pragma unroll
  for (int col = 0; col < S; ++col) {
    T e[S], x[S];
#pragma unroll
    for (int r = 0; r < S; ++r) e[r] = r == col ? T(1) : T(0);
    chol_solve_r(l, rd, e, x);
#pragma unroll
    for (int r = 0; r < S; ++r) inv[r][col] = x[r];
  }
}

// Covariance blocks of one chain edge from s x s Schur complements of the
// joint J = [[F, B], [B^T, G]]:
//   X = G^{-1} B^T,  Sig_ii = (F - B X)^{-1},  Sig_ij = -Sig_ii X^T,
//   Sig_jj = G^{-1} + X Sig_ii X^T = G^{-1} - X Sig_ij.
// Two s x s factorizations instead of one 2s x 2s one: at s = 6 the joint
// and its factor would hold about 300 values in one lane's registers.
template <typename T, int S, bool Fast = false>
__device__ __forceinline__ void edge_covariance_schur(const T (&f)[S][S],
                                                      const T (&g)[S][S],
                                                      const T (&bo)[S][S],
                                                      T (&cii)[S][S],
                                                      T (&cjj)[S][S],
                                                      T (&cij)[S][S]) {
  T lg[S][S], rg[S], x[S][S];
  chol_r<T, S, Fast>(g, lg, rg);
#pragma unroll
  for (int c = 0; c < S; ++c) {
    T rhs[S], sol[S];
#pragma unroll
    for (int r = 0; r < S; ++r) rhs[r] = bo[c][r];
    chol_solve_r(lg, rg, rhs, sol);
#pragma unroll
    for (int r = 0; r < S; ++r) x[r][c] = sol[r];
  }
  {
    T p[S][S], lp[S][S], rp[S];
#pragma unroll
    for (int a = 0; a < S; ++a)
#pragma unroll
      for (int c = 0; c < S; ++c) {
        T acc = f[a][c];
#pragma unroll
        for (int k = 0; k < S; ++k) acc = acc - bo[a][k] * x[k][c];
        p[a][c] = acc;
      }
    chol_r<T, S, Fast>(p, lp, rp);
    inv_from_chol_r(lp, rp, cii);
  }
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int c = 0; c < S; ++c) {
      T acc = cii[a][0] * x[c][0];
#pragma unroll
      for (int k = 1; k < S; ++k) acc = acc + cii[a][k] * x[c][k];
      cij[a][c] = -acc;
    }
  inv_from_chol_r(lg, rg, cjj);
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int c = 0; c < S; ++c) {
      T acc = cjj[a][c];
#pragma unroll
      for (int k = 0; k < S; ++k) acc = acc - x[a][k] * cij[k][c];
      cjj[a][c] = acc;
    }
}

// Covariance blocks of one chain edge: the inverse of the 2s x 2s joint
// [[F, B], [B^T, G]] column by column from its Cholesky factor; cii =
// Sig_ii, cjj = Sig_{i+1,i+1}, cij = Sig_{i,i+1}.  Above s = 4 the same
// blocks come from edge_covariance_schur.  At s in {2, 4} the joint stays:
// it sums in the plain version's order (ops/blocktridiag.py
// gbp_edge_covariance), to whose float32 results the kernels are held.
// The Schur form there ran K5 5% faster at s = 4 but put K6's float32
// gradient off the plain version's beyond that tolerance (PERF.md,
// section 6).
template <typename T, int S, bool Fast = false>
__device__ __forceinline__ void edge_covariance_r(const T (&f)[S][S],
                                                  const T (&g)[S][S],
                                                  const T (&bo)[S][S],
                                                  T (&cii)[S][S],
                                                  T (&cjj)[S][S],
                                                  T (&cij)[S][S]) {
  if constexpr (S > 4) {
    edge_covariance_schur<T, S, Fast>(f, g, bo, cii, cjj, cij);
  } else {
    constexpr int S2 = 2 * S;
    T joint[S2][S2], l[S2][S2], rd[S2];
#pragma unroll
    for (int a = 0; a < S; ++a)
#pragma unroll
      for (int c = 0; c < S; ++c) {
        joint[a][c] = f[a][c];
        joint[a][S + c] = bo[a][c];
        joint[S + a][c] = bo[c][a];
        joint[S + a][S + c] = g[a][c];
      }
    chol_r(joint, l, rd);
#pragma unroll
    for (int col = 0; col < S2; ++col) {
      T e[S2], x[S2];
#pragma unroll
      for (int r = 0; r < S2; ++r) e[r] = r == col ? T(1) : T(0);
      chol_solve_r(l, rd, e, x);
#pragma unroll
      for (int a = 0; a < S; ++a) {
        if (col < S) {
          cii[a][col] = x[a];
        } else {
          cij[a][col - S] = x[a];
          cjj[a][col - S] = x[S + a];
        }
      }
    }
  }
}

// An s x s block stored contiguously in device memory at a 16-byte
// aligned address, read through L1 in 16-byte pieces: a warp whose lanes
// read a few blocks then issues a quarter of the scalar loads (and of the
// cache-line requests each of them makes).  A block smaller than a piece
// (s = 1) is read as it is.
template <typename T, int S>
__device__ __forceinline__ void load_block_vec(const T* src, T (&a)[S][S]) {
  constexpr int kPer = 16 / sizeof(T);
  if constexpr (S * S % kPer != 0) {   // s = 1: a block is one value
    load_mat(src, 1, a);
    return;
  }
  T flat[S * S];
#pragma unroll
  for (int j = 0; j < S * S / kPer; ++j) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src) + j);
    memcpy(&flat[j * kPer], &v, 16);
  }
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) a[r][c] = flat[r * S + c];
}

// A block-tridiagonal precision's blocks as pivot_sweeps takes them: D_i
// and B_e, P values apart: Pitch<S>::kMat in an arena, or S * S in device
// memory (problem-major, 16-byte aligned, read in 16-byte pieces).
template <typename T, int S, int P = Pitch<S>::kMat>
struct ChainBlocks {
  const T* pd;
  const T* po;
  __device__ __forceinline__ void diag(int i, T (&d)[S][S]) const {
    if constexpr (P == S * S)
      load_block_vec(pd + i * P, d);
    else
      load_mat(pd + i * P, 1, d);
  }
  // B_e, or B_e^T on side 1
  __device__ __forceinline__ void off(int e, int side, T (&bd)[S][S]) const {
    const T* src = po + e * P;
    T b[S][S];
    if constexpr (P == S * S)
      load_block_vec(src, b);
    else
      load_mat(src, 1, b);
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c) bd[r][c] = side ? b[c][r] : b[r][c];
  }
};

// The S lanes of a group hold the same s x s block: each stores one row
// (its own, `row`), S stores where each lane would make S * S.
template <typename T, int S>
__device__ __forceinline__ void store_rows(T* dst, const T (&a)[S][S],
                                           int row) {
  T v[S];
#pragma unroll
  for (int c = 0; c < S; ++c) v[c] = a[0][c];
#pragma unroll
  for (int r = 1; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) v[c] = r == row ? a[r][c] : v[c];
#pragma unroll
  for (int c = 0; c < S; ++c) dst[row * S + c] = v[c];
}

// The lane whose work a lane repeats.  The lanes that hold whole pairs of
// lane groups (2s lanes each: all 32 at s = 2 and 4, 24 at s = 6) repeat
// themselves; past them a lane repeats the lane as many places from lane
// 0.  A repeating lane computes the same values as the lane it repeats, so
// it may read that lane's group by shuffles and store the same values to
// the same words.
template <int S>
__device__ __forceinline__ int group_lane(int lane) {
  constexpr int kWhole = kWarp / (2 * S) * (2 * S);
  if constexpr (kWhole == kWarp)
    return lane;
  else
    return lane % kWhole;
}

// The lanes of a warp in groups of S: group parity picks one of two
// recursions, the lane's place in its group the column it solves.  Every
// group of the same parity computes the same values, so a shuffle reads its
// own group and no lane idles on a branch.  Lanes past the last whole pair
// of groups take the place of the lane they repeat (group_lane).
template <int S>
struct Lanes {
  int side, col, first;
  __device__ __forceinline__ explicit Lanes(int lane)
      : side((group_lane<S>(lane) / S) & 1),
        col(group_lane<S>(lane) % S),
        first(group_lane<S>(lane) - group_lane<S>(lane) % S) {}
};

// One step of a pivot recursion, the message m = -(Bd^T P^{-1} Bd) from the
// Cholesky factor l of the pivot P and the directed coupling Bd: the lane
// solves column col and forms column col of m in the operation order of
// smallmat.cuh fwd_message / bwd_message (rd = 1 / diag(l)); the group's S
// lanes then exchange their columns.
template <typename T, int S>
__device__ __forceinline__ void message(const T (&l)[S][S],
                                        const T (&rd)[S],
                                        const T (&bd)[S][S],
                                        const Lanes<S>& g, T (&m)[S][S]) {
  T rhs[S], sol[S], mcol[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    rhs[r] = bd[r][0];
#pragma unroll
    for (int c = 1; c < S; ++c)
      if (c == g.col) rhs[r] = bd[r][c];
  }
  chol_solve_r(l, rd, rhs, sol);
#pragma unroll
  for (int a = 0; a < S; ++a) {
    T acc = bd[0][a] * sol[0];
#pragma unroll
    for (int k = 1; k < S; ++k) acc = acc + bd[k][a] * sol[k];
    mcol[a] = -acc;
  }
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int c = 0; c < S; ++c)
      m[a][c] = __shfl_sync(kFullMask, mcol[a], g.first + c);
}

// The forward and the backward pivot recursion of a block-tridiagonal
// precision, the only serial part of its covariance, run by one warp at the
// same time: the groups of side 0 walk the chain upwards (F_i = D_i - B_{i-1}^T
// F_{i-1}^{-1} B_{i-1}), those of side 1 downwards (G_i = D_i - B_i
// G_{i+1}^{-1} B_i^T), with the same code on mirrored data.  blocks
// hands out D_i and the directed coupling (B_e, or B_e^T on side 1).  Pivots
// go to fpiv / gpiv (arena, Pitch<S>::kMat apart; a row per lane of the
// group).  Returns, on the lanes of
// side 0, the Kahan-compensated log det poisoned by the pivot-trust guard;
// the statistic is a running nan_min in one lane's registers, so no
// reduction can drop a NaN.  All 32 lanes must call.  Fast: chol_r's.
template <typename T, int S, bool WithLogdet, bool Fast = false,
          typename Blocks>
__device__ __forceinline__ T pivot_sweeps(const Blocks& blocks, int n,
                                          int lane, T* fpiv, T* gpiv) {
  constexpr int M = Pitch<S>::kMat;
  const Lanes<S> g(lane);
  T* piv_out = g.side ? gpiv : fpiv;
  T m[S][S];
  zero_mat(m);
  T ld = T(0), comp = T(0), trust = T(1);
  for (int t = 0; t < n; ++t) {
    const int i = g.side ? n - 1 - t : t;
    T d[S][S], piv[S][S], l[S][S], rd[S];
    blocks.diag(i, d);
    add_mat(d, m, piv);
    store_rows(piv_out + i * M, piv, g.col);
    chol_r<T, S, Fast>(piv, l, rd);
    if (WithLogdet) {
      trust = pivot_trust(l, piv, d, m, trust);
      kahan_add(ld, comp, logdet_from_chol(l));
    }
    if (t < n - 1) {
      T bd[S][S];
      blocks.off(g.side ? i - 1 : i, g.side, bd);
      message(l, rd, bd, g, m);
    }
  }
  __syncwarp();
  return trust >= pivot_trust_tol<T>() ? ld : quiet_nan<T>();
}

// x = A^{-1} v (Negate: A^{-1} (-v)) for one block-tridiagonal system on
// the S lanes of the caller's lane group, by pivoting, elimination and back
// substitution (fused_gradient._solve_sweeps): the lane solves column
// g.col of each message.  Each pivot is factored once; its factor stays in
// lfac (the diagonal as reciprocals) for the back substitution.  x holds
// the eliminated right-hand side until the back sweep overwrites it.  A
// pivot that is not positive definite gives NaN.  All 32 lanes must call
// (each group on its own system, or groups on the same one writing the same
// values).  Fast: chol_r's.
template <typename T, int S, bool Negate, bool Fast = false>
__device__ __forceinline__ void thomas(const T* diag, const T* off,
                                       const T* v, T* lfac, T* x, int n,
                                       const Lanes<S>& g) {
  constexpr int M = Pitch<S>::kMat, V = Pitch<S>::kVec;
  T m[S][S], y[S];
  zero_mat(m);
#pragma unroll
  for (int r = 0; r < S; ++r) y[r] = Negate ? -v[r] : v[r];
  for (int i = 0; i < n; ++i) {
    T d[S][S], piv[S][S], l[S][S], rd[S];
    load_mat(diag + i * M, 1, d);
    add_mat(d, m, piv);
    chol_r<T, S, Fast>(piv, l, rd);
    T lr[S][S];   // the factor with its diagonal as reciprocals
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c) lr[r][c] = r == c ? rd[r] : l[r][c];
    store_rows(lfac + i * M, lr, g.col);
#pragma unroll
    for (int r = 0; r < S; ++r) x[i * V + r] = y[r];
    if (i < n - 1) {
      T bo[S][S], sol[S];
      load_mat(off + i * M, 1, bo);
      message(l, rd, bo, g, m);
      chol_solve_r(l, rd, y, sol);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        T acc = Negate ? -v[(i + 1) * V + r] : v[(i + 1) * V + r];
#pragma unroll
        for (int k = 0; k < S; ++k) acc = acc - bo[k][r] * sol[k];
        y[r] = acc;
      }
    }
  }
  __syncwarp();
  T xnext[S];
  for (int i = n - 1; i >= 0; --i) {
    T l[S][S], rd[S], rhs[S], sol[S];
    load_mat(lfac + i * M, 1, l);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      rd[r] = l[r][r];
      rhs[r] = x[i * V + r];
    }
    if (i < n - 1) {
      T bo[S][S];
      load_mat(off + i * M, 1, bo);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < S; ++c) acc = acc + bo[r][c] * xnext[c];
        rhs[r] = rhs[r] - acc;
      }
    }
    chol_solve_r(l, rd, rhs, sol);
    // every lane of a group reads slot i above and writes it below: all
    // read before any writes
    __syncwarp();
#pragma unroll
    for (int r = 0; r < S; ++r) {
      x[i * V + r] = sol[r];
      xnext[r] = sol[r];
    }
  }
  __syncwarp();
}

// x = A^{-1} (-v) for two block-tridiagonal systems at once: the lane
// groups of side 0 solve (diag0, off0) into x0, those of side 1 (diag1,
// off1) into x1, with the same code (thomas).  All 32 lanes must call.
template <typename T, int S, bool Fast = false>
__device__ __forceinline__ void thomas_pair(const T* diag0, const T* off0,
                                            const T* diag1, const T* off1,
                                            const T* v, T* lfac0, T* lfac1,
                                            T* x0, T* x1, int n, int lane) {
  const Lanes<S> g(lane);
  thomas<T, S, true, Fast>(g.side ? diag1 : diag0, g.side ? off1 : off0, v,
                     g.side ? lfac1 : lfac0, g.side ? x1 : x0, n, g);
}

}  // namespace gvi
