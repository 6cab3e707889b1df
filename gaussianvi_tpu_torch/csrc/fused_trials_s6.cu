// The fused trial kernel K5 at s = 6 (the 3-D planners, chain estimation
// at dim_x = 3): fused_trials.cu's entry point sends this block size here.
//
// It computes what trials_kernel computes (fused_trials.cu: the note there
// says what and why) with another layout of its parallel phase, and
// replaces the same TPU kernel (gaussianvi_tpu/kernels/fused_trials.py
// _trials_kernel).  trials_kernel at s = 6 takes a (trial, edge) item on
// one thread, which holds the six s x s blocks of the Schur form and walks
// the state's whole rule alone (251-255 registers, 0.6 KB spilled a
// thread; two blocks an SM).  Here:
//   - phase A as trials_kernel's: both pivot recursions of two trials on a
//     warp, 2s lanes a trial (fused.cuh pivot_sweeps), the pivots of the
//     trials held into the arena;
//   - phase B: a (trial, edge) item on a group of eight lanes (fused_s6.cuh
//     edge_cols: a column of each block a lane; the Schur complement, then
//     Sig_ii, and X published in the edge's pivot slots), sixteen items at
//     a time over the block's four warps.  The state's E[phi] spreads the
//     rule's nodes over the group's lanes; each lane takes the factor of
//     Sig_ii from the arena for its nodes.  A linear factor's residual rows
//     are spread over the lanes, its trace <A, Sig> summed by columns, a
//     lane its own, then over the group;
//   - every factorization, in both phases, takes chol_r's Fast factor
//     (fused.cuh: a reciprocal square root where the IEEE square root and
//     division waited in each column's chain);
//   - the plan (kernels/fused_trials.py trial_plan) holds fewer trials at
//     once than fit shared memory, so that TrialS6Blocks blocks share an
//     SM (the launch bounds cap a thread's registers to match): a sweep's
//     latency is what the SM waits on, and other blocks' warps are what
//     hide it.
// What bounds it: as trials_kernel, the latency of dependent s x s
// algebra at the occupancy it reaches.  Bits: the covariance blocks are
// edge_covariance_schur's with the Fast factor; E[phi] and the traces sum
// in another order than trials_kernel's.
#include "fused_s6.cuh"
#include "fused_trials.cuh"

namespace gvi {

// Blocks of K5 an SM is to hold at s = 6, by dtype (kernels/fused_trials.py
// TRIAL_S6_BLOCKS: the plan's shared memory per block follows it): four
// cap a float32 thread at 128 registers, two leave a float64 one 255.
template <typename T>
struct TrialS6Blocks {
  static constexpr int value = sizeof(T) == 4 ? 4 : 2;
};

// Guarded E[phi] of every nonlinear factor and cost of every span-1 linear
// factor at state i of problem b, marginal N(mu_c, cov) with cov whole in
// the arena (row-major) and its column g.c in cov_c; tb is the (trial,
// problem) row of the [T, B, K] outputs.  The group's lanes call together;
// lane 0 stores.
template <typename T, int S, typename Cost>
__device__ __forceinline__ void state_costs_group(
    const Factors<T>& f, const T* rules, int n, int i, const T* cov_s,
    const T (&cov_c)[S], const T (&mu_c)[S], int64_t b, int64_t tb,
    const GroupLanes<S>& g) {
  for (int j = 0; j < f.n_nl; ++j) {
    const NLBatch<T>& fb = f.nl[j];
    for_factors_at(fb.index, n, i, [&](int k) {
      T cov[S][S], l[S][S], rd[S], p[Cost::kParams], acc, absum, ax[S],
          axx[Tri<S>::value];
      load_mat(cov_s, 1, cov);
      chol_r<T, S, true>(cov, l, rd);
      load_params<T, Cost>(fb, k, b, p);
      sigma_sums<T, S, Cost, false>(l, mu_c, p, fb.field, rules + fb.smem,
                                    rules + fb.smem + fb.m * S, fb.m, acc,
                                    absum, ax, axx, fb.quant, g.gl, kGroup);
      acc = gsum(acc, g.mask);
      absum = gsum(absum, g.mask);
      if (g.gl == 0) fb.fc[tb * fb.k + k] = guard_phi(acc, absum, fb.nonneg);
    });
  }
  for (int j = 0; j < f.n_lin; ++j) {
    const LinBatch<T>& lb = f.lin[j];
    if (lb.span != 1) continue;
    for_factors_at(lb.index, n, i, [&](int k) {
      const int kk = min(k, lb.ka - 1);
      T res[2 * S], w[2 * S];
      lin_residual_group<T, S, 2 * S>(lb, kk, b, mu_c, g, res, w);
      T acc = res[0] * w[0];
#pragma unroll
      for (int rr = 1; rr < 2 * S; ++rr)
        if (rr < lb.r) acc = acc + res[rr] * w[rr];
      const T* a = lb.a + (b * lb.ka + kk) * S * S;
      T part = T(0);
      if (g.active) {
#pragma unroll
        for (int r = 0; r < S; ++r) part = part + a[r * S + g.c] * cov_c[r];
      }
      part = gsum(part, g.mask);
      if (g.gl == 0) lb.fc[tb * lb.k + k] = guard_linear(acc + part);
    });
  }
}

// grid: B blocks.  chunk: trials the arena holds at once.  scratch: the
// arena of every block where the chain does not fit shared memory, else
// null.
template <typename T, typename Cost>
__global__ void __launch_bounds__(kTrialWarps * kWarp, TrialS6Blocks<T>::value)
trials_s6_kernel(const T* __restrict__ mu_g, const T* __restrict__ dmu_g,
                 const T* __restrict__ pd_g, const T* __restrict__ po_g,
                 const T* __restrict__ dpd_g, const T* __restrict__ dpo_g,
                 const T* __restrict__ trials, T* __restrict__ ld_out,
                 T* __restrict__ scratch, int nb, int n, int nt, int chunk,
                 const __grid_constant__ Factors<T> f) {
  constexpr int S = 6, M = Pitch<S>::kMat, SS = S * S;
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

  const int tid = threadIdx.x, threads = blockDim.x;
  copy_in<T, SS>(pd, M, pd_g + b * mats, n, tid, threads);
  copy_in<T, SS>(dpd, M, dpd_g + b * mats, n, tid, threads);
  copy_in<T, SS>(po, M, po_g + b * offs, n - 1, tid, threads);
  copy_in<T, SS>(dpo, M, dpo_g + b * offs, n - 1, tid, threads);
  __syncthreads();

  const int warp = tid / kWarp, lane = tid % kWarp, warps = threads / kWarp;
  const GroupLanes<S> g(lane);
  const int group = warp * kGroups + g.g, groups = warps * kGroups;
  const int edges = n - 1;
  // every thread takes every turn of this loop: it holds block barriers
  for (int t0 = 0; t0 < nt; t0 += chunk) {
    const int held = min(chunk, nt - t0);

    // ---- phase A: trials_kernel's, both pivot recursions of every trial
    // held, 2s lanes each ---------------------------------------------------
    const int gl = group_lane<S>(lane);
    for (int first = warp * kPerWarp; first < held;
         first += warps * kPerWarp) {
      const int slot = min(first + gl / kPerTrial, held - 1);
      const TrialBlocks<T, S> prec{pd, dpd, po, dpo, trials[t0 + slot]};
      T* fpiv = pivots + (int64_t)slot * 2 * n * M;
      const T ld = pivot_sweeps<T, S, true, true>(prec, n, lane, fpiv,
                                                  fpiv + n * M);
      if (lane == gl && gl % kPerTrial == 0 && first + gl / kPerTrial < held)
        ld_out[(int64_t)(t0 + slot) * nb + b] = ld;
    }
    __syncthreads();

    // ---- phase B: one (trial, edge) item per lane group and turn ---------
    for (int item = group; item < held * edges; item += groups) {
      const int slot = item / edges, i = item % edges;
      const T st = trials[t0 + slot];
      const int64_t tb = (int64_t)(t0 + slot) * nb + b;
      T* fslot = pivots + (int64_t)slot * 2 * n * M + i * M;
      T* gslot = fslot + (n + 1) * M;   // G_{i+1}
      const TrialCoupling<T, S> bo{po + i * M, dpo + i * M, st};
      T cii[S], cij[S], cjj[S];
      edge_cols<T, S>(fslot, gslot, bo, true, g, cii, cij, cjj);

      T mu_i[S], mu_j[S];
#pragma unroll
      for (int r = 0; r < S; ++r) {
        mu_i[r] = mu[i * S + r] + st * dmu[i * S + r];
        mu_j[r] = mu[(i + 1) * S + r] + st * dmu[(i + 1) * S + r];
      }
      state_costs_group<T, S, Cost>(f, rules, n, i, fslot, cii, mu_i, b, tb,
                                    g);
      if (i == edges - 1) {
        // Sig_jj of the last state, published where X was
        __syncwarp(g.mask);
        store_col(gslot, cjj, g);
        __syncwarp(g.mask);
        state_costs_group<T, S, Cost>(f, rules, n, n - 1, gslot, cjj, mu_j,
                                      b, tb, g);
      }

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
          T acc = res[0] * w[0];
#pragma unroll
          for (int rr = 1; rr < 2 * S; ++rr)
            if (rr < lb.r) acc = acc + res[rr] * w[rr];
          const T* a = lb.a + (b * lb.ka + kk) * 3 * SS;
          T part = T(0);
          if (g.active) {
#pragma unroll
            for (int r = 0; r < S; ++r) {
              const int at = r * S + g.c;
              part = part + a[at] * cii[r];
              part = part + a[SS + at] * cjj[r];
              part = part + T(2) * a[2 * SS + at] * cij[r];
            }
          }
          part = gsum(part, g.mask);
          if (g.gl == 0) lb.fc[tb * lb.k + k] = guard_linear(acc + part);
        });
      }
    }
    // the next chunk overwrites the pivots
    __syncthreads();
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
  // the wrapper sized the arena: both sides must lay a block out alike
  if (warps != kTrialWarps || chunk < 1 ||
      arena != trial_arena_elems<6>(n, chunk))
    return -1;
  const size_t smem = smem_bytes(f, scratch == nullptr ? (size_t)arena : 0);
  if (smem > kMaxSmem) return -1;
  auto kernel = trials_s6_kernel<T, Cost>;
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
