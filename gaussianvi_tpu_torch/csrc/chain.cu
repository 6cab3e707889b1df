// Chain kernels K1 (gvi_gbp) and K2 (gvi_solve): the C entry points and
// the instances at s in {2, 4, 6}; chain.cuh has the kernels and says what
// they compute, chain_wide.cu the instances at s = 1 and s = 14.
#include "chain.cuh"

// dtype: 0 = float32, 1 = float64.  arena: gbp_warp_elems values per warp;
// scratch: the arenas of all warps where they do not fit shared memory, else
// null.  Returns the cudaError_t of the launch (0 = success) or -1 for sizes
// that are not instantiated.
extern "C" int gvi_gbp(int dtype, int s, const void* diag, const void* off,
                       void* covd, void* covo, void* ld, void* scratch,
                       int nb, int n, long long arena, void* stream) {
  if (nb <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (s == 1 || s == 14)
    return gvi::launch_gbp_s1_s14(dtype, s, diag, off, covd, covo, ld,
                                  scratch, nb, n, arena, st);
#define GVI_GBP(T, S)                                                         \
  return gvi::launch_gbp<T, S>(diag, off, covd, covo, ld, scratch, nb, n,    \
                               arena, st);
  if (dtype == 0 && s == 2) { GVI_GBP(float, 2) }
  if (dtype == 0 && s == 4) { GVI_GBP(float, 4) }
  if (dtype == 0 && s == 6) { GVI_GBP(float, 6) }
  if (dtype == 1 && s == 2) { GVI_GBP(double, 2) }
  if (dtype == 1 && s == 4) { GVI_GBP(double, 4) }
  if (dtype == 1 && s == 6) { GVI_GBP(double, 6) }
#undef GVI_GBP
  return -1;
}

// ops: d0, o0, v0, x0, d1, o1, v1, x1 (pair u: chain u of each system, of
// system 1 only for u < units1).  arena (solve_warp_elems values per warp),
// scratch and the return value as gvi_gbp.
extern "C" int gvi_solve(int dtype, int s, const void* const* ops,
                         void* scratch, int units, int units1, int n,
                         long long arena, void* stream) {
  if (units <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (s == 1 || s == 14)
    return gvi::launch_solve_s1_s14(dtype, s, ops, scratch, units, units1, n,
                                    arena, st);
#define GVI_SOLVE(T, S)                                                       \
  return gvi::launch_solve<T, S>(ops, scratch, units, units1, n, arena, st);
  if (dtype == 0 && s == 2) { GVI_SOLVE(float, 2) }
  if (dtype == 0 && s == 4) { GVI_SOLVE(float, 4) }
  if (dtype == 0 && s == 6) { GVI_SOLVE(float, 6) }
  if (dtype == 1 && s == 2) { GVI_SOLVE(double, 2) }
  if (dtype == 1 && s == 4) { GVI_SOLVE(double, 4) }
  if (dtype == 1 && s == 6) { GVI_SOLVE(double, 6) }
#undef GVI_SOLVE
  return -1;
}
