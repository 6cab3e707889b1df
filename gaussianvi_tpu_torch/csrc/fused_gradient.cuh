// The NGD gradient step of one iteration in one kernel, in three modes.
//
// Replaces the TPU kernel gaussianvi_tpu/kernels/fused_gradient.py,
// gradient_lanes (_grad_kernel, modes "full", "accum" and "solve").  Mode
// "full" runs every phase:
//   0. zero the joint accumulators Vdmu, Vddmu (diag and off);
//   1. forward sweep over Lambda: pivots (kept in scratch), Kahan-
//      compensated log det poisoned by the pivot-trust guard;
//   2. backward sweep fused with each edge's 2s x 2s joint inverse: the
//      covariance blocks are written out (the iteration's record) and the
//      state's marginal feeds at once the sigma-point moments with the
//      marginal-rule lift, the NGD local gradients
//      Vdmu_k = P E[(x-mu)phi] / T, Vddmu_k = (sym(P E P) - P E[phi]) / T,
//      and the linear factors' closed-form gradients from the residual form
//      (Vdmu = 2 Lam^T prec_c (Lam mu - pm) / T, Vddmu = 2 A / T);
//   3. dprec = Vddmu - Lambda;
//   4. block-Thomas solve Vddmu dmu = -Vdmu, pivoting Vddmu in place;
//   5. the SPD fallback solve Lambda dmu_fb = -Vdmu on phase 1's pivots.
// The other two modes split that program where a factor-parallel run sums
// the partial gradients of its ranks:
//   "accum": phases 0-2 over the nonlinear factors it is given (one rank's
//     shard), without log det and without the covariance record; the
//     accumulators vdmu, vdd, vdo are its outputs, and the caller sums them
//     over the ranks;
//   "solve": the accumulators arrive holding that sum (phase 0 is skipped),
//     phases 1-2 run again for the log det, the covariance record and the
//     linear factors (which every rank holds), then phases 3-5.
// The mode is a template parameter: each mode's kernel contains only its
// own phases (one .cu file per mode, so the three compile side by side).
// An indefinite Vddmu gives NaN in dmu (sqrt of a negative pivot), never a
// trap; the loop then takes dmu_fb.  Moments are unguarded, as on every
// path of the JAX package; only the log det carries the trust guard.
//
// Design: one thread per problem, batch-last arrays ([element, B]) so a
// warp's 32 problems touch neighbouring words.  Scratch is global and
// batch-last (fpiv, vdd, vdo, vdmu; at B = 1024, N = 32, s = 4 in float32
// each is at most 2 MB, resident in the 50 MB L2); the eliminated
// right-hand side of each solve is kept in its output, which the back
// substitution overwrites (as csrc/chain.cu's solve does).
//
// What bounds it on the card: latency.  B = 1024 problems are 1024
// threads; blocks of 32 spread them over 32 SMs of 132, and each thread
// runs the chain, M-node quadrature per state and two solves serially, with
// enough live s x s blocks to spill in float64.  A warp per problem (the
// s x s entries and the rule nodes across lanes), or splitting the edge
// inverse across lanes, is later work.
#pragma once

#include "fused.cuh"

namespace gvi {

constexpr int kGradThreads = 32;

enum GradMode { kGradFull = 0, kGradAccum = 1, kGradSolve = 2 };

template <typename T, int S>
__device__ __forceinline__ void zero_mat(T (&a)[S][S]) {
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) a[r][c] = T(0);
}

// acc_block += a * scale, one s x s block of a width-nb accumulator.
template <typename T, int S>
__device__ __forceinline__ void accumulate(T* acc, int64_t nb,
                                           const T (&a)[S][S], T scale) {
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const int64_t e = (int64_t)(r * S + c) * nb;
      acc[e] = acc[e] + a[r][c] * scale;
    }
}

// Joint gradient contributions of every nonlinear (not in mode "solve")
// and span-1 linear (not in mode "accum") factor at state i, marginal
// N(mu_c, cov).  vdmu_i / vdd_i point at state i.
template <typename T, int S, typename Cost, int Mode>
__device__ __forceinline__ void state_gradients(
    const Factors<T>& f, const T* smem, int i, const T (&cov)[S][S],
    const T (&mu_c)[S], int64_t nb, int64_t b, T inv_t, T* vdmu_i,
    T* vdd_i) {
  // a compile-time zero drops the loop from the mode that never runs it
  const int n_nl = Mode == kGradSolve ? 0 : f.n_nl;
  const int n_lin = Mode == kGradAccum ? 0 : f.n_lin;
  for (int j = 0; j < n_nl; ++j) {
    const NLBatch<T>& fb = f.nl[j];
    for_factors_at(fb.starts, fb.offset, fb.k, i, [&](int k) {
      T l[S][S], p[Cost::kParams], e_phi, absum, e_x[S], e_tri[Tri<S>::value];
      chol(cov, l);
      load_params<T, Cost>(fb, k, nb, b, p);
      sigma_sums<T, S, Cost, true>(l, mu_c, p, smem + fb.smem,
                                   smem + fb.smem + fb.m * S, fb.m, e_phi,
                                   absum, e_x, e_tri);
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
      inv_from_chol(l, prec);
      // Vdmu_k = P E[(x-mu) phi] / T
      T vd[S];
#pragma unroll
      for (int r = 0; r < S; ++r) {
        T acc = vdmu_i[r * nb];
#pragma unroll
        for (int c = 0; c < S; ++c) acc = acc + prec[r][c] * e_x[c] * inv_t;
        vd[r] = acc;
      }
#pragma unroll
      for (int r = 0; r < S; ++r) vdmu_i[r * nb] = vd[r];
      // Vddmu_k = (sym(P E P) - P E[phi]) / T
      matmul(prec, exx, pe);
      matmul(pe, prec, pep);
#pragma unroll
      for (int a = 0; a < S; ++a)
#pragma unroll
        for (int c = 0; c < S; ++c) {
          const int64_t e = (int64_t)(a * S + c) * nb;
          vdd_i[e] = vdd_i[e] + (T(0.5) * (pep[a][c] + pep[c][a]) -
                                 prec[a][c] * e_phi) * inv_t;
        }
    });
  }
  for (int j = 0; j < n_lin; ++j) {
    const LinBatch<T>& lb = f.lin[j];
    if (lb.span != 1) continue;
    for_factors_at(lb.starts, lb.offset, lb.k, i, [&](int k) {
      const int kk = min(k, lb.ka - 1);
      T res[2 * S], w[2 * S], a[S][S], vd[S];
      lin_residual<T, S, 2 * S>(lb, kk, nb, b, mu_c, res, w);
#pragma unroll
      for (int d = 0; d < S; ++d) {
        T acc = vdmu_i[d * nb];
#pragma unroll
        for (int rr = 0; rr < 2 * S; ++rr)
          if (rr < lb.r)
            acc = acc + T(2) * lb.lam[(((int64_t)kk * lb.r + rr) * S + d) * nb + b] *
                            w[rr] * inv_t;
        vd[d] = acc;
      }
#pragma unroll
      for (int d = 0; d < S; ++d) vdmu_i[d * nb] = vd[d];
      load_a<T, S>(lb, kk, 0, nb, b, a);
      accumulate(vdd_i, nb, a, T(2) * inv_t);
    });
  }
}

// x = A^{-1} (-vdmu) for block-tridiagonal A with forward pivots piv (as
// stored by the sweep) and super-diagonal blocks off, by elimination and
// back substitution (fused_gradient._solve_sweeps).  x holds the
// eliminated right-hand side until the back sweep overwrites it.
template <typename T, int S>
__device__ __forceinline__ void thomas_solve(const T* piv, const T* off,
                                             const T* vdmu, T* x, int64_t nb,
                                             int n) {
  const int64_t blk = (int64_t)S * S * nb;
  const int64_t vec = (int64_t)S * nb;
#pragma unroll
  for (int r = 0; r < S; ++r) x[r * nb] = -vdmu[r * nb];
  for (int i = 1; i < n; ++i) {
    T p[S][S], l[S][S], bo[S][S], yprev[S], sol[S];
    load_mat(piv + (i - 1) * blk, nb, p);
    chol(p, l);
#pragma unroll
    for (int r = 0; r < S; ++r) yprev[r] = x[(i - 1) * vec + r * nb];
    chol_solve_vec(l, yprev, sol);
    load_mat(off + (i - 1) * blk, nb, bo);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      T acc = -vdmu[i * vec + r * nb];
#pragma unroll
      for (int k = 0; k < S; ++k) acc = acc - bo[k][r] * sol[k];
      x[i * vec + r * nb] = acc;
    }
  }
  T xnext[S];
  for (int i = n - 1; i >= 0; --i) {
    T p[S][S], l[S][S], rhs[S], sol[S];
    load_mat(piv + i * blk, nb, p);
    chol(p, l);
#pragma unroll
    for (int r = 0; r < S; ++r) rhs[r] = x[i * vec + r * nb];
    if (i < n - 1) {
      T bo[S][S];
      load_mat(off + i * blk, nb, bo);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < S; ++c) acc = acc + bo[r][c] * xnext[c];
        rhs[r] = rhs[r] - acc;
      }
    }
    chol_solve_vec(l, rhs, sol);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      x[i * vec + r * nb] = sol[r];
      xnext[r] = sol[r];
    }
  }
}

// Mode "accum" takes null pointers for covd .. dfb; mode "solve" takes
// vdd, vdo, vdmu holding the summed partial gradients.
template <typename T, int S, typename Cost, int Mode>
__global__ void __launch_bounds__(kGradThreads)
grad_kernel(const T* __restrict__ mu, const T* __restrict__ pd,
            const T* __restrict__ po, const T* __restrict__ temp,
            T* __restrict__ covd, T* __restrict__ covo, T* __restrict__ ld_out,
            T* __restrict__ dpd, T* __restrict__ dpo, T* __restrict__ dmu,
            T* __restrict__ dfb, T* __restrict__ fpiv, T* __restrict__ vdd,
            T* __restrict__ vdo, T* __restrict__ vdmu, int nb_, int n,
            const __grid_constant__ Factors<T> f) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  load_rules<T, S>(f, smem);

  const int64_t nb = nb_;
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int64_t blk = (int64_t)S * S * nb;
  const int64_t vec = (int64_t)S * nb;
  mu += b; pd += b; po += b; fpiv += b; vdd += b; vdo += b; vdmu += b;
  if constexpr (Mode != kGradAccum) {
    covd += b; covo += b; dpd += b; dpo += b; dmu += b; dfb += b;
  }
  const T inv_t = T(1) / temp[b];

  // ---- phase 0: zero the accumulators (mode "solve": they hold the sum) --
  T m[S][S];
  zero_mat(m);
  if constexpr (Mode != kGradSolve) {
    for (int i = 0; i < n; ++i) {
      store_mat(vdd + i * blk, nb, m);
      if (i < n - 1) store_mat(vdo + i * blk, nb, m);
#pragma unroll
      for (int r = 0; r < S; ++r) vdmu[i * vec + r * nb] = T(0);
    }
  }

  // ---- phase 1: forward sweep over Lambda -------------------------------
  T ld = T(0), comp = T(0), trust = T(1);
  for (int i = 0; i < n; ++i) {
    T d[S][S], piv[S][S], l[S][S];
    load_mat(pd + i * blk, nb, d);
    add_mat(d, m, piv);
    store_mat(fpiv + i * blk, nb, piv);
    chol(piv, l);
    if constexpr (Mode != kGradAccum) {
      trust = pivot_trust(l, piv, d, m, trust);
      kahan_add(ld, comp, logdet_from_chol(l));
    }
    if (i < n - 1) {
      T bo[S][S];
      load_mat(po + i * blk, nb, bo);
      fwd_message(l, bo, m);
    }
  }
  if constexpr (Mode != kGradAccum)
    ld_out[b] = trust >= pivot_trust_tol<T>() ? ld : quiet_nan<T>();

  // ---- phase 2: backward sweep fused with the edge inverse + gradients --
  zero_mat(m);
  for (int i = n - 2; i >= 0; --i) {
    T fp[S][S], g[S][S], bo[S][S], cii[S][S], cjj[S][S], cij[S][S];
    load_mat(fpiv + i * blk, nb, fp);
    {
      T d[S][S];
      load_mat(pd + (i + 1) * blk, nb, d);
      add_mat(d, m, g);
    }
    load_mat(po + i * blk, nb, bo);
    edge_covariance(fp, g, bo, cii, cjj, cij);
    if constexpr (Mode != kGradAccum) {
      store_mat(covd + i * blk, nb, cii);
      store_mat(covo + i * blk, nb, cij);
    }

    T mu_i[S], mu_j[S];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      mu_i[r] = mu[i * vec + r * nb];
      mu_j[r] = mu[(i + 1) * vec + r * nb];
    }
    state_gradients<T, S, Cost, Mode>(f, smem, i, cii, mu_i, nb, b, inv_t,
                                      vdmu + i * vec, vdd + i * blk);
    if (i == n - 2) {
      if constexpr (Mode != kGradAccum)
        store_mat(covd + (int64_t)(n - 1) * blk, nb, cjj);
      state_gradients<T, S, Cost, Mode>(f, smem, n - 1, cjj, mu_j, nb, b,
                                        inv_t, vdmu + (n - 1) * vec,
                                        vdd + (n - 1) * blk);
    }

    const int n_lin = Mode == kGradAccum ? 0 : f.n_lin;
    for (int j = 0; j < n_lin; ++j) {
      const LinBatch<T>& lb = f.lin[j];
      if (lb.span != 2) continue;
      for_factors_at(lb.starts, lb.offset, lb.k, i, [&](int k) {
        const int kk = min(k, lb.ka - 1);
        T mu_e[2 * S], res[2 * S], w[2 * S], vd_i[S], vd_j[S], a[S][S];
#pragma unroll
        for (int r = 0; r < S; ++r) {
          mu_e[r] = mu_i[r];
          mu_e[S + r] = mu_j[r];
        }
        lin_residual<T, 2 * S, 2 * S>(lb, kk, nb, b, mu_e, res, w);
#pragma unroll
        for (int d = 0; d < S; ++d) {
          T acc_i = vdmu[i * vec + d * nb];
          T acc_j = vdmu[(i + 1) * vec + d * nb];
#pragma unroll
          for (int rr = 0; rr < 2 * S; ++rr) {
            if (rr < lb.r) {
              const int64_t row = ((int64_t)kk * lb.r + rr) * 2 * S;
              acc_i = acc_i + T(2) * lb.lam[(row + d) * nb + b] * w[rr] * inv_t;
              acc_j = acc_j +
                      T(2) * lb.lam[(row + S + d) * nb + b] * w[rr] * inv_t;
            }
          }
          vd_i[d] = acc_i;
          vd_j[d] = acc_j;
        }
#pragma unroll
        for (int d = 0; d < S; ++d) {
          vdmu[i * vec + d * nb] = vd_i[d];
          vdmu[(i + 1) * vec + d * nb] = vd_j[d];
        }
        const T two_t = T(2) * inv_t;
        load_a<T, S>(lb, kk, 0, nb, b, a);
        accumulate(vdd + i * blk, nb, a, two_t);
        load_a<T, S>(lb, kk, 1, nb, b, a);
        accumulate(vdd + (i + 1) * blk, nb, a, two_t);
        load_a<T, S>(lb, kk, 2, nb, b, a);
        accumulate(vdo + i * blk, nb, a, two_t);
      });
    }

    if (i > 0) {
      T lg[S][S];
      chol(g, lg);
      bwd_message(lg, bo, m);
    }
  }

  // mode "accum" ends here: vdmu, vdd, vdo are its outputs
  if constexpr (Mode == kGradAccum) return;

  // ---- phase 3: dprec = Vddmu - Lambda ----------------------------------
  for (int i = 0; i < n; ++i) {
    T v[S][S], d[S][S];
    load_mat(vdd + i * blk, nb, v);
    load_mat(pd + i * blk, nb, d);
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c) v[r][c] = v[r][c] - d[r][c];
    store_mat(dpd + i * blk, nb, v);
    if (i < n - 1) {
      load_mat(vdo + i * blk, nb, v);
      load_mat(po + i * blk, nb, d);
#pragma unroll
      for (int r = 0; r < S; ++r)
#pragma unroll
        for (int c = 0; c < S; ++c) v[r][c] = v[r][c] - d[r][c];
      store_mat(dpo + i * blk, nb, v);
    }
  }

  // ---- phase 4: Thomas solve over Vddmu, pivoted in place ----------------
  zero_mat(m);
  for (int i = 0; i < n; ++i) {
    T v[S][S], piv[S][S], l[S][S];
    load_mat(vdd + i * blk, nb, v);
    add_mat(v, m, piv);
    store_mat(vdd + i * blk, nb, piv);
    if (i < n - 1) {
      T bo[S][S];
      chol(piv, l);
      load_mat(vdo + i * blk, nb, bo);
      fwd_message(l, bo, m);
    }
  }
  thomas_solve<T, S>(vdd, vdo, vdmu, dmu, nb, n);

  // ---- phase 5: SPD fallback over Lambda on phase 1's pivots -------------
  thomas_solve<T, S>(fpiv, po, vdmu, dfb, nb, n);
}

template <typename T, int S, typename Cost, int Mode>
int dispatch_grad(const void* mu, const void* pd, const void* po,
                  const void* temp, void* covd, void* covo, void* ld,
                  void* dpd, void* dpo, void* dmu, void* dfb, void* fpiv,
                  void* vdd, void* vdo, void* vdmu, int nb, int n, int n_nl,
                  void* const* nl_ptrs, const int* nl_ints, int n_lin,
                  void* const* lin_ptrs, const int* lin_ints,
                  cudaStream_t st) {
  Factors<T> f;
  size_t smem = 0;
  if (!parse_factors<T, S>(n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs, lin_ints,
                           f, smem))
    return -1;
  const int blocks = (nb + kGradThreads - 1) / kGradThreads;
  grad_kernel<T, S, Cost, Mode><<<blocks, kGradThreads, smem, st>>>(
      static_cast<const T*>(mu), static_cast<const T*>(pd),
      static_cast<const T*>(po), static_cast<const T*>(temp),
      static_cast<T*>(covd), static_cast<T*>(covo), static_cast<T*>(ld),
      static_cast<T*>(dpd), static_cast<T*>(dpo), static_cast<T*>(dmu),
      static_cast<T*>(dfb), static_cast<T*>(fpiv), static_cast<T*>(vdd),
      static_cast<T*>(vdo), static_cast<T*>(vdmu), nb, n, f);
  return static_cast<int>(cudaGetLastError());
}

// One mode's instantiations (float32 / float64, s = 2 / 4, the range cost).
// dtype: 0 = float32, 1 = float64; cost: csrc/costs.cuh CostId with np
// params.  Returns the cudaError_t of the launch (0 = success) or -1 for
// sizes that are not instantiated.
template <int Mode>
int launch_grad(int dtype, int s, int cost, int np, const void* mu,
                const void* pd, const void* po, const void* temp, void* covd,
                void* covo, void* ld, void* dpd, void* dpo, void* dmu,
                void* dfb, void* fpiv, void* vdd, void* vdo, void* vdmu,
                int nb, int n, int n_nl, void* const* nl_ptrs,
                const int* nl_ints, int n_lin, void* const* lin_ptrs,
                const int* lin_ints, void* stream) {
  if (nb <= 0) return 0;
  if (cost != kRangeCost) return -1;
  auto st = static_cast<cudaStream_t>(stream);
#define GVI_GRAD(T, S, DX)                                                     \
  if (np != RangeCost<DX>::kParams) return -1;                                \
  return dispatch_grad<T, S, RangeCost<DX>, Mode>(                            \
      mu, pd, po, temp, covd, covo, ld, dpd, dpo, dmu, dfb, fpiv, vdd, vdo,   \
      vdmu, nb, n, n_nl, nl_ptrs, nl_ints, n_lin, lin_ptrs, lin_ints, st);
  if (dtype == 0 && s == 2) { GVI_GRAD(float, 2, 1) }
  if (dtype == 0 && s == 4) { GVI_GRAD(float, 4, 2) }
  if (dtype == 1 && s == 2) { GVI_GRAD(double, 2, 1) }
  if (dtype == 1 && s == 4) { GVI_GRAD(double, 4, 2) }
#undef GVI_GRAD
  return -1;
}

}  // namespace gvi

// The C entry point of one mode: every mode takes the same arguments.
#define GVI_GRAD_ENTRY(NAME, MODE)                                             \
  extern "C" int NAME(int dtype, int s, int cost, int np, const void* mu,     \
                      const void* pd, const void* po, const void* temp,       \
                      void* covd, void* covo, void* ld, void* dpd, void* dpo, \
                      void* dmu, void* dfb, void* fpiv, void* vdd, void* vdo, \
                      void* vdmu, int nb, int n, int n_nl,                    \
                      void* const* nl_ptrs, const int* nl_ints, int n_lin,    \
                      void* const* lin_ptrs, const int* lin_ints,             \
                      void* stream) {                                         \
    return gvi::launch_grad<MODE>(dtype, s, cost, np, mu, pd, po, temp, covd, \
                                  covo, ld, dpd, dpo, dmu, dfb, fpiv, vdd,    \
                                  vdo, vdmu, nb, n, n_nl, nl_ptrs, nl_ints,   \
                                  n_lin, lin_ptrs, lin_ints, stream);         \
  }
