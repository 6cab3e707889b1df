// What the fused trial kernel's two layouts share (fused_trials.cu says
// what K5 computes and how each layout answers the card): trials_kernel at
// s in {2, 4} (fused_trials.cu) and the lane groups at s = 6
// (fused_trials_s6.cu) stage a problem and its direction in an arena of
// the same size and form the trial precision alike.
#pragma once

#include "fused.cuh"

namespace gvi {

// Warps of a block (both layouts).
constexpr int kTrialWarps = 4;

// Arena of one block that holds `chunk` trials at once, in values of T: pd,
// dpd, po, dpo as n blocks each, then per trial F and G as n blocks each
// (kernels/fused_trials.py trial_arena_elems is the wrapper's copy).
template <int S>
__host__ __device__ constexpr int64_t trial_stage_elems(int64_t n) {
  return n * 4 * Pitch<S>::kMat;
}

template <int S>
__host__ __device__ constexpr int64_t trial_arena_elems(int64_t n,
                                                        int64_t chunk) {
  return trial_stage_elems<S>(n) + chunk * 2 * n * Pitch<S>::kMat;
}

// The blocks of the trial precision sym(Lambda + st dLambda), formed from
// the staged iterate and direction as pivot_sweeps asks for them.
template <typename T, int S>
struct TrialBlocks {
  const T* pd;
  const T* dpd;
  const T* po;
  const T* dpo;
  T st;
  __device__ __forceinline__ void diag(int i, T (&d)[S][S]) const {
    const T* x = pd + i * Pitch<S>::kMat;
    const T* dx = dpd + i * Pitch<S>::kMat;
    T a[S][S];
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c) a[r][c] = x[r * S + c] + st * dx[r * S + c];
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c) d[r][c] = T(0.5) * (a[r][c] + a[c][r]);
  }
  // B_e, or B_e^T on side 1
  __device__ __forceinline__ void off(int e, int side, T (&bd)[S][S]) const {
    const T* x = po + e * Pitch<S>::kMat;
    const T* dx = dpo + e * Pitch<S>::kMat;
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c) {
        const int at = side ? c * S + r : r * S + c;
        bd[r][c] = x[at] + st * dx[at];
      }
  }
};

// K5 at s = 6 (fused_trials_s6.cu), gvi_fused_trials's arguments.
int launch_trials_s6(int dtype, int cost, int np, const void* mu,
                     const void* dmu, const void* pd, const void* po,
                     const void* dpd, const void* dpo, const void* trials,
                     void* ld, void* scratch, int nb, int n, int nt,
                     int warps, int chunk, long long arena, int n_nl,
                     void* const* nl_ptrs, const int* nl_ints, int n_lin,
                     void* const* lin_ptrs, const int* lin_ints,
                     cudaStream_t st);

}  // namespace gvi
