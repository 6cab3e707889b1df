// The fused trial kernel K5 at s = 6 (the 3-D planners, chain estimation
// at dim_x = 3): fused_trials.cu's entry point sends this block size here.
//
// It computes what trials_kernel computes (fused_trials.cu: the note there
// says what and why) and replaces the same TPU kernel (gaussianvi_tpu/
// kernels/fused_trials.py _trials_kernel), in two passes the entry
// launches one after the other on the caller's stream:
//   1. trials_s6_kernel_sweep: K1's s = 6 layout (chain.cuh gbp_kernel)
//      over the T x B trial chains, chain u = b T + t, so that the trials
//      of a problem sit in neighbouring warps and its blocks come from L2
//      after the first read.  A block is one warp and carries two chains,
//      2s lanes each, through both pivot recursions at once (fused.cuh
//      pivot_sweeps: the Kahan log det with the 8-eps pivot-trust guard),
//      then its (chain, edge) items a lane each: the edge's covariance
//      blocks (the Schur form, edge_covariance_schur) and, from them, the
//      costs of the linear factors at the edge and at its first state (the
//      last edge: at its second state too).  Every factorization takes
//      chol_r's Fast factor.  Each trial's precision sym(Lambda + st
//      dLambda) is formed as its blocks are read (TrialChainBlocks).  Out:
//      the log det to ld, the linear costs to their fc, and each state's
//      marginal covariance Sig_ii to the scratch the wrapper allocates
//      (trial_s6_block_elems values, row t B + b of the [T, B] outputs);
//   2. trials_s6_kernel_costs: K3's phi layout (quad.cuh quad_kernel at a
//      lane a factor) over the (trial, problem, state) items, a lane each:
//      one factorization of the state's Sig_ii, read from the scratch,
//      and the guarded E[phi] of each nonlinear factor at the state over
//      its whole rule (in shared memory, every lane at the same node: a
//      broadcast).
// Why: a chain's sweeps are latency-bound, and warps in flight are what
// hide a step's latency.  The layout this replaced held a problem on a
// 128-thread block through block barriers, in chunks of trials its arena
// could hold, two trials a warp in the sweeps, and every lane of an
// 8-lane group factored the same covariance for its share of the nodes;
// K1 and K3 did the same work in half the time (PERF.md, section 6).  The
// linear costs stay with the edge that formed the blocks: an edge's
// blocks from one Schur form make a joint marginal that is positive
// definite up to rounding, where Sig_jj taken from the next edge's form
// made float32 costs go negative (NaN by the guard) on ill-conditioned
// trials, and the scratch then carries the n marginals alone.
// What bounds it: pass 1 as K1, the latency of dependent s x s algebra at
// the occupancy its registers leave; pass 2 the rule's nodes.  Bits: no
// atomics, a fixed order, the same bits on every launch; the log det and
// blocks differ from K1's on the trial batch by the Fast factor's
// rounding, E[phi] is K3's on those blocks.
#include <atomic>

#include "chain.cuh"
#include "fused_trials.cuh"

namespace gvi {

// Threads of a block of pass 2 (kernels/quad.py QUAD_THREADS).
constexpr int kTrialCostThreads = 128;

// The blocks of trial st's precision sym(Lambda + st dLambda) of one
// problem, formed from the iterate's blocks and the step's as pivot_sweeps
// reads them (device memory, row-major s x s, 16-byte aligned), in
// fused_trials.cuh TrialBlocks' arithmetic.
template <typename T, int S>
struct TrialChainBlocks {
  const T* pd;
  const T* dpd;
  const T* po;
  const T* dpo;
  T st;
  __device__ __forceinline__ void form(const T* x_g, const T* dx_g,
                                       T (&a)[S][S]) const {
    T x[S][S], dx[S][S];
    load_block_vec(x_g, x);
    load_block_vec(dx_g, dx);
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c) a[r][c] = x[r][c] + st * dx[r][c];
  }
  __device__ __forceinline__ void diag(int i, T (&d)[S][S]) const {
    T a[S][S];
    form(pd + i * S * S, dpd + i * S * S, a);
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c)
        d[r][c] = T(0.5) * (a[r][c] + a[c][r]);
  }
  // B_e, or B_e^T on side 1
  __device__ __forceinline__ void off(int e, int side, T (&bd)[S][S]) const {
    T a[S][S];
    form(po + e * S * S, dpo + e * S * S, a);
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c) bd[r][c] = side ? a[c][r] : a[r][c];
  }
};

// Values of the scratch that carries pass 1's blocks to pass 2: per trial
// chain, the marginal covariance Sig_ii of each of its n states
// (kernels/fused_trials.py trial_s6_block_elems).
__host__ __device__ constexpr int64_t trial_s6_block_elems(int64_t chains,
                                                           int64_t n) {
  return chains * n * 36;
}

// The trial mean mu_i + st dmu_i of state i.
template <typename T, int S>
__device__ __forceinline__ void trial_mean(const T* mu, const T* dmu, T st,
                                           int i, T (&out)[S]) {
#pragma unroll
  for (int r = 0; r < S; ++r) out[r] = mu[i * S + r] + st * dmu[i * S + r];
}

// The guarded cost of every span-1 linear factor at state i of problem b,
// marginal N(mu_c, cov); tb is the (trial, problem) row of the [T, B, K]
// outputs (fused_trials.cu state_costs' linear half).
template <typename T, int S>
__device__ __forceinline__ void anchor_costs(const Factors<T>& f, int n,
                                             int i, int64_t b, int64_t tb,
                                             const T (&mu_c)[S],
                                             const T (&cov)[S][S]) {
  for (int j = 0; j < f.n_lin; ++j) {
    const LinBatch<T>& lb = f.lin[j];
    if (lb.span != 1) continue;
    for_factors_at(lb.index, n, i, [&](int k) {
      const int kk = min(k, lb.ka - 1);
      T res[2 * S], w[2 * S];
      lin_residual<T, S, 2 * S>(lb, kk, b, mu_c, res, w);
      T acc = res[0] * w[0];
#pragma unroll
      for (int rr = 1; rr < 2 * S; ++rr)
        if (rr < lb.r) acc = acc + res[rr] * w[rr];
      const T* a = lb.a + (b * lb.ka + kk) * S * S;
#pragma unroll
      for (int r = 0; r < S; ++r)
#pragma unroll
        for (int c = 0; c < S; ++c) acc = acc + a[r * S + c] * cov[r][c];
      lb.fc[tb * lb.k + k] = guard_linear(acc);
    });
  }
}

// The guarded cost of every span-2 linear factor on edge (i, i + 1) of
// problem b, from the edge's own covariance blocks (its joint marginal,
// positive definite up to rounding, so the cost's trace and square stay
// apart from cancellation) (fused_trials.cu trials_kernel's phase B).
template <typename T, int S>
__device__ __forceinline__ void edge_costs(const Factors<T>& f, int n, int i,
                                           int64_t b, int64_t tb,
                                           const T (&mu_i)[S],
                                           const T (&mu_j)[S],
                                           const T (&cii)[S][S],
                                           const T (&cjj)[S][S],
                                           const T (&cij)[S][S]) {
  constexpr int SS = S * S;
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
      lin_residual<T, 2 * S, 2 * S>(lb, kk, b, mu_e, res, w);
      T acc = res[0] * w[0];
#pragma unroll
      for (int rr = 1; rr < 2 * S; ++rr)
        if (rr < lb.r) acc = acc + res[rr] * w[rr];
      const T* a = lb.a + (b * lb.ka + kk) * 3 * SS;
#pragma unroll
      for (int r = 0; r < S; ++r)
#pragma unroll
        for (int c = 0; c < S; ++c) {
          const int at = r * S + c;
          acc = acc + a[at] * cii[r][c];
          acc = acc + a[SS + at] * cjj[r][c];
          acc = acc + T(2) * a[2 * SS + at] * cij[r][c];
        }
      lb.fc[tb * lb.k + k] = guard_linear(acc);
    });
  }
}

// Pass 1.  grid: chain_blocks<6>(T B) one-warp blocks.  arenas: the pivot
// arenas of every warp where they do not fit shared memory, else null.
template <typename T>
__global__ void __launch_bounds__(kWarp)
trials_s6_kernel_sweep(const T* __restrict__ mu_g, const T* __restrict__ dmu_g,
                       const T* __restrict__ pd_g, const T* __restrict__ po_g,
                       const T* __restrict__ dpd_g,
                       const T* __restrict__ dpo_g,
                       const T* __restrict__ trials, T* __restrict__ ld_out,
                       T* __restrict__ blocks, T* __restrict__ arenas, int nb,
                       int n, int nt, const __grid_constant__ Factors<T> f) {
  constexpr int S = 6, M = Pitch<S>::kMat, SS = S * S, C = PerWarp<S>::value;
  const int lane = threadIdx.x;
  const int64_t chains = (int64_t)nt * nb;
  const int64_t u0 = (int64_t)blockIdx.x * C;   // the warp's first chain
  const int valid = (int)min((int64_t)C, chains - u0);
  const int64_t cp = slot_pitch<T>(n * M, C);
  T* fpiv = warp_arena(arenas, gbp_warp_elems<T, S>(n));
  T* gpiv = fpiv + C * cp;
  const int64_t mats = (int64_t)n * SS, offs = (int64_t)(n - 1) * SS;
  // chain q of the warp: trial t of problem b, row t B + b of the outputs
  auto problem = [&](int q) { return (u0 + q) / nt; };
  auto trial = [&](int q) { return u0 + q - problem(q) * nt; };
  auto row = [&](int q) { return trial(q) * nb + problem(q); };
  auto chain = [&](int q) {
    const int64_t b = problem(q);
    return TrialChainBlocks<T, S>{pd_g + b * mats, dpd_g + b * mats,
                                  po_g + b * offs, dpo_g + b * offs,
                                  trials[trial(q)]};
  };

  // ---- both pivot recursions of every chain, 2s lanes each; a lane past
  // the last chain, or past the warp's whole lane groups, repeats another
  // (same values to the same words) ------------------------------------
  const int gl = group_lane<S>(lane);
  const int c = min(gl / (2 * S), valid - 1);
  const T ld = pivot_sweeps<T, S, true, true>(chain(c), n, lane,
                                              fpiv + c * cp, gpiv + c * cp);
  if (lane == gl && gl % (2 * S) == 0 && gl / (2 * S) < valid)
    ld_out[row(c)] = ld;

  // ---- the edges, one (chain, edge) item per lane and turn: the edge's
  // covariance blocks, its linear factors' costs (span 1 at state i, and at
  // the last state on the last edge; span 2 on the edge), and Sig_ii staged
  // where the item's own pivot F_i was (the last state's Sig_jj in F_{N-1};
  // no other item reads F_i) ---------------------------------------------
  const int edges = n - 1;
  for (int e = lane; e < valid * edges; e += kWarp) {
    const int q = e / edges, i = e % edges;
    T* fq = fpiv + q * cp;
    T cii[S][S], cjj[S][S], cij[S][S];
    {
      T fp[S][S], g[S][S], bo[S][S];
      load_mat(fq + i * M, 1, fp);
      load_mat(gpiv + q * cp + (i + 1) * M, 1, g);
      chain(q).off(i, 0, bo);
      edge_covariance_schur<T, S, true>(fp, g, bo, cii, cjj, cij);
    }
    store_mat(fq + i * M, 1, cii);
    if (i == edges - 1) store_mat(fq + (i + 1) * M, 1, cjj);
    const int64_t b = problem(q), tb = row(q);
    const T st = trials[trial(q)];
    T mu_i[S], mu_j[S];
    trial_mean(mu_g + b * n * S, dmu_g + b * n * S, st, i, mu_i);
    trial_mean(mu_g + b * n * S, dmu_g + b * n * S, st, i + 1, mu_j);
    anchor_costs(f, n, i, b, tb, mu_i, cii);
    if (i == edges - 1) anchor_costs(f, n, i + 1, b, tb, mu_j, cjj);
    edge_costs(f, n, i, b, tb, mu_i, mu_j, cii, cjj, cij);
  }
  __syncwarp();

  // ---- the marginals out, chain by chain ------------------------------
  for (int q = 0; q < valid; ++q)
    copy_out<T, SS>(blocks + row(q) * mats, fpiv + q * cp, M, n, lane, kWarp);
}

// Pass 2.  grid: T B n items over blocks of kTrialCostThreads, item
// (t B + b) n + i the state i of trial t of problem b: the guarded E[phi]
// of every nonlinear factor at the state.
template <typename T, typename Cost>
__global__ void __launch_bounds__(kTrialCostThreads)
trials_s6_kernel_costs(const T* __restrict__ mu_g, const T* __restrict__ dmu_g,
                       const T* __restrict__ trials,
                       const T* __restrict__ blocks, int nb, int n, int nt,
                       const __grid_constant__ Factors<T> f) {
  constexpr int S = 6, SS = S * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rules = reinterpret_cast<T*>(smem_raw);
  load_rules<T, S>(f, rules);

  const int64_t item = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (int64_t)nt * nb * n) return;
  const int64_t tb = item / n;           // the row of the [T, B] outputs
  const int i = (int)(item - tb * n);
  const int64_t t = tb / nb, b = tb - t * nb;
  T mu_i[S], l[S][S];
  trial_mean(mu_g + b * n * S, dmu_g + b * n * S, trials[t], i, mu_i);
  {
    T cov[S][S];
    load_block_vec(blocks + item * SS, cov);
    chol(cov, l);
  }
  for (int j = 0; j < f.n_nl; ++j) {
    const NLBatch<T>& fb = f.nl[j];
    for_factors_at(fb.index, n, i, [&](int k) {
      T p[Cost::kParams], acc, absum, ax[S], axx[Tri<S>::value];
      load_params<T, Cost>(fb, k, b, p);
      sigma_sums<T, S, Cost, false>(l, mu_i, p, fb.field, rules + fb.smem,
                                    rules + fb.smem + fb.m * S, fb.m, acc,
                                    absum, ax, axx, fb.quant);
      fb.fc[tb * fb.k + k] = guard_phi(acc, absum, fb.nonneg);
    });
  }
}

template <typename T, typename Cost>
int dispatch_trials_s6(const void* mu, const void* dmu, const void* pd,
                       const void* po, const void* dpd, const void* dpo,
                       const void* trials, void* ld, void* scratch, int nb,
                       int n, int nt, int warps, int chunk, long long arena,
                       int n_nl, void* const* nl_ptrs, const int* nl_ints,
                       int n_lin, void* const* lin_ptrs, const int* lin_ints,
                       cudaStream_t st) {
  Factors<T> f;
  if (!parse_factors<T, 6>(n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs,
                           lin_ints, f) ||
      !fields_ok<Cost>(f))
    return -1;
  // the wrapper planned one-warp blocks over every trial at once and sized
  // the arena and the scratch: both sides must lay them out alike
  if (warps != 1 || chunk != nt || arena != gbp_warp_elems<T, 6>(n) ||
      scratch == nullptr)
    return -1;
  // pass 1 reads the blocks through L1 in 16-byte pieces (load_block_vec),
  // pass 2 the scratch
  if (((reinterpret_cast<uintptr_t>(pd) | reinterpret_cast<uintptr_t>(po) |
        reinterpret_cast<uintptr_t>(dpd) | reinterpret_cast<uintptr_t>(dpo) |
        reinterpret_cast<uintptr_t>(scratch)) & 15) != 0)
    return -1;
  const size_t rules = smem_bytes(f, 0);
  if (rules > kMaxSmem) return -1;
  const int64_t chains = (int64_t)nt * nb;
  const bool arena_shared = sizeof(T) * (size_t)arena <= kMaxSmem;
  T* blocks = static_cast<T*>(scratch);
  T* arenas = arena_shared ? nullptr
                           : blocks + trial_s6_block_elems(chains, n);

  static std::atomic<uint64_t> smem_allowed{0};
  const cudaError_t prep =
      allow_smem_once(trials_s6_kernel_sweep<T>, smem_allowed);
  if (prep != cudaSuccess) return static_cast<int>(prep);
  auto costs = trials_s6_kernel_costs<T, Cost>;
  const cudaError_t attr = allow_smem(costs, rules);
  if (attr != cudaSuccess) return static_cast<int>(attr);

  trials_s6_kernel_sweep<T><<<chain_blocks<6>(chains), kWarp,
                              arena_shared ? sizeof(T) * arena : 0, st>>>(
      static_cast<const T*>(mu), static_cast<const T*>(dmu),
      static_cast<const T*>(pd), static_cast<const T*>(po),
      static_cast<const T*>(dpd), static_cast<const T*>(dpo),
      static_cast<const T*>(trials), static_cast<T*>(ld), blocks, arenas, nb,
      n, nt, f);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  const int64_t items = chains * n;
  costs<<<(int)((items + kTrialCostThreads - 1) / kTrialCostThreads),
          kTrialCostThreads, rules, st>>>(
      static_cast<const T*>(mu), static_cast<const T*>(dmu),
      static_cast<const T*>(trials), blocks, nb, n, nt, f);
  return static_cast<int>(cudaGetLastError());
}

// The range cost (dim_x = 3) and the 3-D SDF, float32 and float64.
int launch_trials_s6(int dtype, int cost, int np, const void* mu,
                     const void* dmu, const void* pd, const void* po,
                     const void* dpd, const void* dpo, const void* trials,
                     void* ld, void* scratch, int nb, int n, int nt,
                     int warps, int chunk, long long arena, int n_nl,
                     void* const* nl_ptrs, const int* nl_ints, int n_lin,
                     void* const* lin_ptrs, const int* lin_ints,
                     cudaStream_t st) {
#define GVI_TRIALS_S6(T, COST)                                                \
  {                                                                           \
    if (np != COST::kParams) return -1;                                       \
    return dispatch_trials_s6<T, COST>(                                       \
        mu, dmu, pd, po, dpd, dpo, trials, ld, scratch, nb, n, nt, warps,     \
        chunk, arena, n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs, lin_ints, st); \
  }
  if (cost == kRangeCost) {
    if (dtype == 0) GVI_TRIALS_S6(float, RangeCost<3>)
    if (dtype == 1) GVI_TRIALS_S6(double, RangeCost<3>)
  }
  if (cost == kSdf3dCost) {
    if (dtype == 0) GVI_TRIALS_S6(float, Sdf3dCost)
    if (dtype == 1) GVI_TRIALS_S6(double, Sdf3dCost)
  }
#undef GVI_TRIALS_S6
  return -1;
}

}  // namespace gvi
