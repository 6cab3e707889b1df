// All line-search trials of one NGD iteration in one kernel.
//
// Replaces the TPU kernel gaussianvi_tpu/kernels/fused_trials.py,
// trial_costs_lanes (_trials_kernel): for every trial step s_t and problem
// b it forms the trial iterate mu + s_t dmu, sym(Lambda + s_t dLambda) on
// the fly (the [T, B, N, s, s] trial tensors never reach device memory),
// runs both GBP pivot recursions with a Kahan-compensated,
// pivot-trust-poisoned log det, then each edge's 2s x 2s joint inverse: as
// Sig_ii, Sig_jj, Sig_ij come out they are consumed at once by the state's
// nonlinear E[phi] (rule in shared memory), the anchor costs (span 1) and
// the edge costs (span 2), and dropped.  Outputs: ld [T, B] and per batch
// fc [T, B, K].
//
// Guards: unlike the TPU kernel (log-det guard only), E[phi] carries the
// 64-ulp cancellation guard and, for nonnegative costs, the 4096-ulp band,
// and a negative linear cost is NaN: the contract of the separate path
// (factors/moments.py), so every path rejects the same trials.
//
// What bounds it on the card: as the gradient kernel (fused_gradient.cuh),
// the latency and the sheer count of dependent s x s operations along
// T * B chains, at the occupancy the edge inverse's registers leave; bytes
// and operations would take microseconds.  Two layouts answer it, both
// with this entry and the same arena (fused_trials.cuh):
//   - s in {2, 4}: trials_kernel below, a block per problem:
//     the problem's precision and its direction are staged in the arena
//     once (shared memory; a global scratch for a chain too long for it)
//     and read for all T trials; the means, read once per item, stay where
//     they are.  Phase A, the serial part, for all trials at once: 2s
//     lanes per trial (both pivot recursions at the same time, the s
//     columns of a message on s lanes: fused.cuh pivot_sweeps), so a warp
//     walks 32 / 2s chains and T = 11 trials at s = 4 take three warps,
//     not eleven; each trial's forward and backward pivots stay in the
//     arena.  Phase B, behind one block barrier: the T * (N - 1) (trial,
//     edge) items spread over all threads of the block, one a thread: the
//     joint inverse, the guarded E[phi] of the state's factors, the span-1
//     and span-2 linear costs, each written where the caller reads it
//     ([T, B, K]: neighbouring items write neighbouring words).  More
//     trials than the arena holds go in chunks through the same two
//     phases;
//   - s = 6: fused_trials_s6.cu, two passes: K1's s = 6 layout over the
//     T x B trial chains (one-warp blocks, no block barrier), the
//     covariance blocks through a scratch, then a lane a (trial, problem,
//     state) item for the costs.  A thread that holds a whole s = 6 edge
//     item beside a rule's sums needs all 255 registers and spills; the
//     passes split the two.
// Factor operands (params, the linear rows) are read in place through L1:
// they are a few hundred bytes per problem and shared by the T trials.
#include "fused_trials.cuh"

namespace gvi {

// Blocks the compiler is to fit on an SM: at the flagship (N = 32, s = 4,
// T = 11, float32) a block's arena takes 56 KB, so four share an SM if
// each thread keeps to 128 registers; the serial sweeps are
// latency-bound, and the warps of other blocks are what hide it.
constexpr int kTrialBlocksPerSM = 4;

// Guarded E[phi] of every nonlinear factor and cost of every span-1
// linear factor at state i of problem b, marginal N(mu_c, cov); tb is the
// (trial, problem) row of the [T, B, K] outputs.
template <typename T, int S, typename Cost>
__device__ __forceinline__ void state_costs(const Factors<T>& f,
                                            const T* rules, int n, int i,
                                            const T (&cov)[S][S],
                                            const T (&mu_c)[S], int64_t b,
                                            int64_t tb) {
  for (int j = 0; j < f.n_nl; ++j) {
    const NLBatch<T>& fb = f.nl[j];
    for_factors_at(fb.index, n, i, [&](int k) {
      T l[S][S], p[Cost::kParams], acc, absum, ax[S], axx[Tri<S>::value];
      chol(cov, l);
      load_params<T, Cost>(fb, k, b, p);
      sigma_sums<T, S, Cost, false>(l, mu_c, p, fb.field, rules + fb.smem,
                                    rules + fb.smem + fb.m * S, fb.m, acc,
                                    absum, ax, axx, fb.quant);
      fb.fc[tb * fb.k + k] = guard_phi(acc, absum, fb.nonneg);
    });
  }
  for (int j = 0; j < f.n_lin; ++j) {
    const LinBatch<T>& lb = f.lin[j];
    if (lb.span != 1) continue;
    for_factors_at(lb.index, n, i, [&](int k) {
      const int kk = min(k, lb.ka - 1);
      T res[2 * S], w[2 * S], a[S][S];
      lin_residual<T, S, 2 * S>(lb, kk, b, mu_c, res, w);
      T acc = res[0] * w[0];
#pragma unroll
      for (int rr = 1; rr < 2 * S; ++rr)
        if (rr < lb.r) acc = acc + res[rr] * w[rr];
      load_a<T, S>(lb, kk, 0, b, a);
#pragma unroll
      for (int r = 0; r < S; ++r)
#pragma unroll
        for (int c = 0; c < S; ++c) acc = acc + a[r][c] * cov[r][c];
      lb.fc[tb * lb.k + k] = guard_linear(acc);
    });
  }
}

// grid: B blocks.  chunk: trials the arena holds at once.  scratch: the
// arena of every block where the chain does not fit shared memory, else
// null.
template <typename T, int S, typename Cost>
__global__ void __launch_bounds__(kTrialWarps * kWarp, kTrialBlocksPerSM)
trials_kernel(const T* __restrict__ mu_g, const T* __restrict__ dmu_g,
              const T* __restrict__ pd_g, const T* __restrict__ po_g,
              const T* __restrict__ dpd_g, const T* __restrict__ dpo_g,
              const T* __restrict__ trials, T* __restrict__ ld_out,
              T* __restrict__ scratch, int nb, int n, int nt, int chunk,
              const __grid_constant__ Factors<T> f) {
  constexpr int M = Pitch<S>::kMat, SS = S * S;
  constexpr int kPerTrial = 2 * S;               // lanes of one trial
  constexpr int kPerWarp = kWarp / kPerTrial;    // trials of one warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rules = reinterpret_cast<T*>(smem_raw);
  const int64_t arena_elems = trial_arena_elems<S>(n, chunk);
  T* arena = scratch == nullptr
                 ? rules + f.rule_elems
                 : scratch + (int64_t)blockIdx.x * arena_elems;
  load_rules<T, S>(f, rules);

  const int64_t b = blockIdx.x;
  T* pd = arena;
  T* dpd = pd + n * M;
  T* po = dpd + n * M;
  T* dpo = po + n * M;
  T* pivots = arena + trial_stage_elems<S>(n);   // per trial: F, then G
  const int64_t mats = (int64_t)n * SS, offs = (int64_t)(n - 1) * SS;
  const T* mu = mu_g + b * n * S;
  const T* dmu = dmu_g + b * n * S;

  // ---- stage the problem once for all its trials (plain coalesced loads:
  // phase A needs all of it at once, an asynchronous copy has nothing to
  // overlap with) -----------------------------------------------------------
  const int tid = threadIdx.x, threads = blockDim.x;
  copy_in<T, SS>(pd, M, pd_g + b * mats, n, tid, threads);
  copy_in<T, SS>(dpd, M, dpd_g + b * mats, n, tid, threads);
  copy_in<T, SS>(po, M, po_g + b * offs, n - 1, tid, threads);
  copy_in<T, SS>(dpo, M, dpo_g + b * offs, n - 1, tid, threads);
  __syncthreads();

  const int warp = tid / kWarp, lane = tid % kWarp, warps = threads / kWarp;
  const int edges = n - 1;
  // every thread takes every turn of this loop: it holds block barriers
  for (int t0 = 0; t0 < nt; t0 += chunk) {
    const int held = min(chunk, nt - t0);

    // ---- phase A: both pivot recursions and the log det of every trial
    // held, 2s lanes each; a lane past the last trial repeats another (same
    // values to the same words) so that the warp stays whole ---------------
    const int gl = group_lane<S>(lane);
    for (int first = warp * kPerWarp; first < held;
         first += warps * kPerWarp) {
      const int slot = min(first + gl / kPerTrial, held - 1);
      const TrialBlocks<T, S> prec{pd, dpd, po, dpo, trials[t0 + slot]};
      T* fpiv = pivots + (int64_t)slot * 2 * n * M;
      const T ld = pivot_sweeps<T, S, true>(prec, n, lane, fpiv,
                                            fpiv + n * M);
      if (lane == gl && gl % kPerTrial == 0 && first + gl / kPerTrial < held)
        ld_out[(int64_t)(t0 + slot) * nb + b] = ld;
    }
    __syncthreads();

    // ---- phase B: one (trial, edge) item per thread and turn -------------
    for (int item = tid; item < held * edges; item += threads) {
      const int slot = item / edges, i = item % edges;
      const T st = trials[t0 + slot];
      const int64_t tb = (int64_t)(t0 + slot) * nb + b;
      const TrialBlocks<T, S> prec{pd, dpd, po, dpo, st};
      const T* fpiv = pivots + (int64_t)slot * 2 * n * M;
      const T* gpiv = fpiv + n * M;
      T fp[S][S], g[S][S], bo[S][S], cii[S][S], cjj[S][S], cij[S][S];
      load_mat(fpiv + i * M, 1, fp);
      load_mat(gpiv + (i + 1) * M, 1, g);
      prec.off(i, 0, bo);
      edge_covariance_r(fp, g, bo, cii, cjj, cij);

      T mu_i[S], mu_j[S];
#pragma unroll
      for (int r = 0; r < S; ++r) {
        mu_i[r] = mu[i * S + r] + st * dmu[i * S + r];
        mu_j[r] = mu[(i + 1) * S + r] + st * dmu[(i + 1) * S + r];
      }
      state_costs<T, S, Cost>(f, rules, n, i, cii, mu_i, b, tb);
      if (i == edges - 1)
        state_costs<T, S, Cost>(f, rules, n, n - 1, cjj, mu_j, b, tb);

      for (int j = 0; j < f.n_lin; ++j) {
        const LinBatch<T>& lb = f.lin[j];
        if (lb.span != 2) continue;
        for_factors_at(lb.index, n, i, [&](int k) {
          const int kk = min(k, lb.ka - 1);
          T mu_e[2 * S], res[2 * S], w[2 * S], a11[S][S], a22[S][S], a12[S][S];
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
          load_a<T, S>(lb, kk, 0, b, a11);
          load_a<T, S>(lb, kk, 1, b, a22);
          load_a<T, S>(lb, kk, 2, b, a12);
#pragma unroll
          for (int r = 0; r < S; ++r)
#pragma unroll
            for (int c = 0; c < S; ++c) {
              acc = acc + a11[r][c] * cii[r][c];
              acc = acc + a22[r][c] * cjj[r][c];
              acc = acc + T(2) * a12[r][c] * cij[r][c];
            }
          lb.fc[tb * lb.k + k] = guard_linear(acc);
        });
      }
    }
    // the next chunk overwrites the pivots
    __syncthreads();
  }
}

template <typename T, int S, typename Cost>
int dispatch_trials(const void* mu, const void* dmu, const void* pd,
                    const void* po, const void* dpd, const void* dpo,
                    const void* trials, void* ld, void* scratch, int nb,
                    int n, int nt, int warps, int chunk, long long arena,
                    int n_nl, void* const* nl_ptrs, const int* nl_ints,
                    int n_lin, void* const* lin_ptrs, const int* lin_ints,
                    cudaStream_t st) {
  Factors<T> f;
  if (!parse_factors<T, S>(n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs,
                           lin_ints, f) ||
      !fields_ok<Cost>(f))
    return -1;
  // the wrapper sized the arena: both sides must lay a block out alike
  if (warps != kTrialWarps || chunk < 1 ||
      arena != trial_arena_elems<S>(n, chunk))
    return -1;
  const size_t smem = smem_bytes(f, scratch == nullptr ? (size_t)arena : 0);
  if (smem > kMaxSmem) return -1;
  auto kernel = trials_kernel<T, S, Cost>;
  const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<nb, warps * kWarp, smem, st>>>(
      static_cast<const T*>(mu), static_cast<const T*>(dmu),
      static_cast<const T*>(pd), static_cast<const T*>(po),
      static_cast<const T*>(dpd), static_cast<const T*>(dpo),
      static_cast<const T*>(trials), static_cast<T*>(ld),
      static_cast<T*>(scratch), nb, n, nt, chunk, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gvi

// dtype: 0 = float32, 1 = float64; cost: csrc/costs.cuh CostId with np
// params (one cost for every nonlinear batch; each batch brings its own
// field, null for the range cost): the range cost at s = 2, 4, 6, the
// planar SDF at s = 2, 4, the 3-D SDF at s = 6.  A block has `warps`
// warps and holds `chunk` trials at once;
// arena = trial_arena_elems values per block, scratch = the global arena
// or null.  s = 6 (fused_trials_s6.cu): one-warp blocks over all trials
// at once (warps 1, chunk nt), arena = K1's gbp_warp_elems, scratch = the
// covariance blocks' scratch, then the arenas where they do not fit
// shared memory.  Returns the cudaError_t of the launch (0 = success) or -1
// for sizes that are not instantiated.
extern "C" int gvi_fused_trials(int dtype, int s, int cost, int np,
                                const void* mu, const void* dmu,
                                const void* pd, const void* po,
                                const void* dpd, const void* dpo,
                                const void* trials, void* ld, void* scratch,
                                int nb, int n, int nt, int warps, int chunk,
                                long long arena, int n_nl,
                                void* const* nl_ptrs, const int* nl_ints,
                                int n_lin, void* const* lin_ptrs,
                                const int* lin_ints, void* stream) {
  if (nb <= 0 || nt <= 0) return 0;
  if (n < 2) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  // s = 6: its own layout and translation unit (fused_trials_s6.cu)
  if (s == 6)
    return gvi::launch_trials_s6(dtype, cost, np, mu, dmu, pd, po, dpd, dpo,
                                 trials, ld, scratch, nb, n, nt, warps, chunk,
                                 arena, n_nl, nl_ptrs, nl_ints, n_lin,
                                 lin_ptrs, lin_ints, st);
#define GVI_TRIALS(T, S, COST)                                                \
  if (np != COST::kParams) return -1;                                        \
  return gvi::dispatch_trials<T, S, COST>(                                   \
      mu, dmu, pd, po, dpd, dpo, trials, ld, scratch, nb, n, nt, warps,      \
      chunk, arena, n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs, lin_ints, st);
  if (cost == gvi::kRangeCost) {
    if (dtype == 0 && s == 2) { GVI_TRIALS(float, 2, gvi::RangeCost<1>) }
    if (dtype == 0 && s == 4) { GVI_TRIALS(float, 4, gvi::RangeCost<2>) }
    if (dtype == 1 && s == 2) { GVI_TRIALS(double, 2, gvi::RangeCost<1>) }
    if (dtype == 1 && s == 4) { GVI_TRIALS(double, 4, gvi::RangeCost<2>) }
  }
  if (cost == gvi::kPlanarSdfCost) {
    if (dtype == 0 && s == 2) { GVI_TRIALS(float, 2, gvi::PlanarSdfCost) }
    if (dtype == 0 && s == 4) { GVI_TRIALS(float, 4, gvi::PlanarSdfCost) }
    if (dtype == 1 && s == 2) { GVI_TRIALS(double, 2, gvi::PlanarSdfCost) }
    if (dtype == 1 && s == 4) { GVI_TRIALS(double, 4, gvi::PlanarSdfCost) }
  }
#undef GVI_TRIALS
  return -1;
}
