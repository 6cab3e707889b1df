// All line-search trials of one NGD iteration in one kernel.
//
// Replaces the TPU kernel gaussianvi_tpu/kernels/fused_trials.py,
// trial_costs_lanes (_trials_kernel): for every trial step s_t and problem
// b it forms the trial iterate mu + s_t dmu, sym(Lambda + s_t dLambda)
// in registers (the [T, B, N, s, s] trial tensors never reach device
// memory), runs the GBP forward sweep with a Kahan-compensated,
// pivot-trust-poisoned log det, then the backward sweep fused with each
// edge's 2s x 2s joint inverse: as Sig_ii, Sig_jj, Sig_ij come out they are
// consumed at once by the state's nonlinear E[phi] (rule in shared memory),
// the anchor costs (span 1) and the edge costs (span 2), and dropped.
// Outputs: ld [T, B] and per batch fc [K, T, B].
//
// Guards: unlike the TPU kernel (log-det guard only), E[phi] carries the
// 64-ulp cancellation guard and, for nonnegative costs, the 4096-ulp band,
// and a negative linear cost is NaN: the contract of the separate path
// (factors/moments.py), so every path rejects the same trials.
//
// Design: one thread per (trial, problem) pair, T * B = 11,264 threads at
// the flagship; problem data are batch-last ([element, B]) so a warp's 32
// problems read neighbouring words, and the T threads of a problem read
// the same words (served by L1/L2).  The forward pivots go to a global
// batch-last scratch [N, s, s, T * B] for the backward sweep.
//
// What bounds it on the card: latency of the serial s x s algebra along
// the chain plus the per-state quadrature (M nodes), at low occupancy
// (176 blocks of 64 threads for 132 SMs at the flagship) and high register
// pressure (the 2s x 2s joint factor, three covariance blocks and the
// quadrature state live at once).  A warp per (trial, problem), or the
// edge inverse split across lanes, is later work.
#include "fused.cuh"

namespace gvi {

constexpr int kTrialThreads = 64;

// x + st * dx for an s x s block of a width-nb array.
template <typename T, int S>
__device__ __forceinline__ void trial_block(const T* x, const T* dx, T st,
                                            int64_t nb, T (&out)[S][S]) {
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const int64_t e = (int64_t)(r * S + c) * nb;
      out[r][c] = x[e] + st * dx[e];
    }
}

template <typename T, int S>
__device__ __forceinline__ void trial_diag(const T* x, const T* dx, T st,
                                           int64_t nb, T (&out)[S][S]) {
  T a[S][S];
  trial_block(x, dx, st, nb, a);
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) out[r][c] = T(0.5) * (a[r][c] + a[c][r]);
}

template <typename T, int S>
__device__ __forceinline__ void trial_vec(const T* x, const T* dx, T st,
                                          int64_t nb, T (&out)[S]) {
#pragma unroll
  for (int r = 0; r < S; ++r) out[r] = x[r * nb] + st * dx[r * nb];
}

// A negative closed-form linear cost is rounding garbage (the cost is
// <A, Sig> + a weighted square >= 0): NaN, as moments.guard_linear_cost.
template <typename T>
__device__ __forceinline__ void store_linear_cost(const LinBatch<T>& lb,
                                                  int k, int64_t count,
                                                  int64_t idx, T cost) {
  lb.fc[(int64_t)k * count + idx] = cost < T(0) ? quiet_nan<T>() : cost;
}

// Guarded E[phi] of every nonlinear factor and cost of every span-1
// linear factor at state i, marginal N(mu_c, cov).
template <typename T, int S, typename Cost>
__device__ __forceinline__ void state_costs(const Factors<T>& f,
                                            const T* smem, int i,
                                            const T (&cov)[S][S],
                                            const T (&mu_c)[S], int64_t nb,
                                            int64_t b, int64_t count,
                                            int64_t idx) {
  for (int j = 0; j < f.n_nl; ++j) {
    const NLBatch<T>& fb = f.nl[j];
    for_factors_at(fb.starts, fb.offset, fb.k, i, [&](int k) {
      T l[S][S], p[Cost::kParams], acc, absum, ax[S], axx[Tri<S>::value];
      chol(cov, l);
      load_params<T, Cost>(fb, k, nb, b, p);
      sigma_sums<T, S, Cost, false>(l, mu_c, p, smem + fb.smem,
                                    smem + fb.smem + fb.m * S, fb.m, acc,
                                    absum, ax, axx);
      fb.fc[(int64_t)k * count + idx] = guard_phi(acc, absum, fb.nonneg);
    });
  }
  for (int j = 0; j < f.n_lin; ++j) {
    const LinBatch<T>& lb = f.lin[j];
    if (lb.span != 1) continue;
    for_factors_at(lb.starts, lb.offset, lb.k, i, [&](int k) {
      const int kk = min(k, lb.ka - 1);
      T res[2 * S], w[2 * S], a[S][S];
      lin_residual<T, S, 2 * S>(lb, kk, nb, b, mu_c, res, w);
      T acc = res[0] * w[0];
#pragma unroll
      for (int rr = 1; rr < 2 * S; ++rr)
        if (rr < lb.r) acc = acc + res[rr] * w[rr];
      load_a<T, S>(lb, kk, 0, nb, b, a);
#pragma unroll
      for (int r = 0; r < S; ++r)
#pragma unroll
        for (int c = 0; c < S; ++c) acc = acc + a[r][c] * cov[r][c];
      store_linear_cost(lb, k, count, idx, acc);
    });
  }
}

template <typename T, int S, typename Cost>
__global__ void __launch_bounds__(kTrialThreads)
trials_kernel(const T* __restrict__ mu, const T* __restrict__ dmu,
              const T* __restrict__ pd, const T* __restrict__ po,
              const T* __restrict__ dpd, const T* __restrict__ dpo,
              const T* __restrict__ trials, T* __restrict__ ld_out,
              T* __restrict__ fpiv, int nb_, int n, int nt,
              const __grid_constant__ Factors<T> f) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  load_rules<T, S>(f, smem);

  const int64_t nb = nb_;
  const int64_t count = nb * nt;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  const int64_t b = idx % nb;
  const T st = trials[idx / nb];
  const int64_t blk = (int64_t)S * S * nb;   // s x s block, width B
  const int64_t vec = (int64_t)S * nb;       // s-vector, width B
  const int64_t tblk = (int64_t)S * S * count;
  mu += b; dmu += b; pd += b; po += b; dpd += b; dpo += b; fpiv += idx;

  // ---- forward sweep: pivots, log det, pivot trust ----------------------
  T m[S][S];
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) m[r][c] = T(0);
  T ld = T(0), comp = T(0), trust = T(1);
  for (int i = 0; i < n; ++i) {
    T d[S][S], piv[S][S], l[S][S];
    trial_diag(pd + i * blk, dpd + i * blk, st, nb, d);
    add_mat(d, m, piv);
    store_mat(fpiv + i * tblk, count, piv);
    chol(piv, l);
    trust = pivot_trust(l, piv, d, m, trust);
    kahan_add(ld, comp, logdet_from_chol(l));
    if (i < n - 1) {
      T bo[S][S];
      trial_block(po + i * blk, dpo + i * blk, st, nb, bo);
      fwd_message(l, bo, m);
    }
  }
  ld_out[idx] = trust >= pivot_trust_tol<T>() ? ld : quiet_nan<T>();

  // ---- backward sweep fused with the edge inverse and the costs ---------
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) m[r][c] = T(0);
  for (int i = n - 2; i >= 0; --i) {
    T fp[S][S], g[S][S], bo[S][S], cii[S][S], cjj[S][S], cij[S][S];
    load_mat(fpiv + i * tblk, count, fp);
    {
      T d[S][S];
      trial_diag(pd + (i + 1) * blk, dpd + (i + 1) * blk, st, nb, d);
      add_mat(d, m, g);
    }
    trial_block(po + i * blk, dpo + i * blk, st, nb, bo);
    edge_covariance(fp, g, bo, cii, cjj, cij);

    T mu_i[S], mu_j[S];
    trial_vec(mu + i * vec, dmu + i * vec, st, nb, mu_i);
    trial_vec(mu + (i + 1) * vec, dmu + (i + 1) * vec, st, nb, mu_j);
    state_costs<T, S, Cost>(f, smem, i, cii, mu_i, nb, b, count, idx);
    if (i == n - 2)
      state_costs<T, S, Cost>(f, smem, n - 1, cjj, mu_j, nb, b, count, idx);

    for (int j = 0; j < f.n_lin; ++j) {
      const LinBatch<T>& lb = f.lin[j];
      if (lb.span != 2) continue;
      for_factors_at(lb.starts, lb.offset, lb.k, i, [&](int k) {
        const int kk = min(k, lb.ka - 1);
        T mu_e[2 * S], res[2 * S], w[2 * S], a11[S][S], a22[S][S], a12[S][S];
#pragma unroll
        for (int r = 0; r < S; ++r) {
          mu_e[r] = mu_i[r];
          mu_e[S + r] = mu_j[r];
        }
        lin_residual<T, 2 * S, 2 * S>(lb, kk, nb, b, mu_e, res, w);
        T acc = res[0] * w[0];
#pragma unroll
        for (int rr = 1; rr < 2 * S; ++rr)
          if (rr < lb.r) acc = acc + res[rr] * w[rr];
        load_a<T, S>(lb, kk, 0, nb, b, a11);
        load_a<T, S>(lb, kk, 1, nb, b, a22);
        load_a<T, S>(lb, kk, 2, nb, b, a12);
#pragma unroll
        for (int r = 0; r < S; ++r)
#pragma unroll
          for (int c = 0; c < S; ++c) {
            acc = acc + a11[r][c] * cii[r][c];
            acc = acc + a22[r][c] * cjj[r][c];
            acc = acc + T(2) * a12[r][c] * cij[r][c];
          }
        store_linear_cost(lb, k, count, idx, acc);
      });
    }

    // next message m_i = -B_i G_{i+1}^{-1} B_i^T
    if (i > 0) {
      T lg[S][S];
      chol(g, lg);
      bwd_message(lg, bo, m);
    }
  }
}

template <typename T, int S, typename Cost>
int launch_trials(const void* mu, const void* dmu, const void* pd,
                  const void* po, const void* dpd, const void* dpo,
                  const void* trials, void* ld, void* fpiv, int nb, int n,
                  int nt, const Factors<T>& f, size_t smem, cudaStream_t st) {
  const int64_t count = (int64_t)nb * nt;
  const int blocks = (int)((count + kTrialThreads - 1) / kTrialThreads);
  trials_kernel<T, S, Cost><<<blocks, kTrialThreads, smem, st>>>(
      static_cast<const T*>(mu), static_cast<const T*>(dmu),
      static_cast<const T*>(pd), static_cast<const T*>(po),
      static_cast<const T*>(dpd), static_cast<const T*>(dpo),
      static_cast<const T*>(trials), static_cast<T*>(ld),
      static_cast<T*>(fpiv), nb, n, nt, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S, typename Cost>
int dispatch_trials(const void* mu, const void* dmu, const void* pd,
                    const void* po, const void* dpd, const void* dpo,
                    const void* trials, void* ld, void* fpiv, int nb, int n,
                    int nt, int n_nl, void* const* nl_ptrs,
                    const int* nl_ints, int n_lin, void* const* lin_ptrs,
                    const int* lin_ints, cudaStream_t st) {
  Factors<T> f;
  size_t smem = 0;
  if (!parse_factors<T, S>(n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs, lin_ints,
                           f, smem))
    return -1;
  return launch_trials<T, S, Cost>(mu, dmu, pd, po, dpd, dpo, trials, ld,
                                   fpiv, nb, n, nt, f, smem, st);
}

}  // namespace gvi

// dtype: 0 = float32, 1 = float64; cost: csrc/costs.cuh CostId with np
// params.  Returns the cudaError_t of the launch (0 = success) or -1 for
// sizes that are not instantiated.
extern "C" int gvi_fused_trials(int dtype, int s, int cost, int np,
                                const void* mu, const void* dmu,
                                const void* pd, const void* po,
                                const void* dpd, const void* dpo,
                                const void* trials, void* ld, void* fpiv,
                                int nb, int n, int nt, int n_nl,
                                void* const* nl_ptrs, const int* nl_ints,
                                int n_lin, void* const* lin_ptrs,
                                const int* lin_ints, void* stream) {
  if (nb <= 0 || nt <= 0) return 0;
  if (cost != gvi::kRangeCost) return -1;
  auto st = static_cast<cudaStream_t>(stream);
#define GVI_TRIALS(T, S, DX)                                                  \
  if (np != gvi::RangeCost<DX>::kParams) return -1;                          \
  return gvi::dispatch_trials<T, S, gvi::RangeCost<DX>>(                     \
      mu, dmu, pd, po, dpd, dpo, trials, ld, fpiv, nb, n, nt, n_nl, nl_ptrs, \
      nl_ints, n_lin, lin_ptrs, lin_ints, st);
  if (dtype == 0 && s == 2) { GVI_TRIALS(float, 2, 1) }
  if (dtype == 0 && s == 4) { GVI_TRIALS(float, 4, 2) }
  if (dtype == 1 && s == 2) { GVI_TRIALS(double, 2, 1) }
  if (dtype == 1 && s == 4) { GVI_TRIALS(double, 4, 2) }
#undef GVI_TRIALS
  return -1;
}
