// Chain kernels over a batch of block-tridiagonal SPD precisions, in the
// layout of block sizes s <= 6 (chain.cu instantiates s in {2, 4, 6},
// chain_wide.cu s = 1; s = 14 takes the layout of chain_wide.cu).
//
// Replaces the TPU kernels of gaussianvi_tpu/kernels/chain_lanes.py:
//   gvi_gbp   <- gbp_covariance_logdet_lanes (_gbp_kernel): both GBP pivot
//                recursions, the covariance diag/off blocks from each edge's
//                2s x 2s joint inverse, the Kahan-compensated log det
//                NaN-poisoned by the 8-eps pivot-trust guard (N = 1: the
//                inverse of the one block);
//   gvi_solve <- solve_lanes (_solve_kernel): block-Thomas solves A x = b,
//                two systems per lane group pair (the NGD step's main system
//                and its SPD fallback against one right-hand side).
//
// What bounds them on the card: the latency and the instruction issue of
// dependent s x s algebra along a chain, not bytes or operations.  K1 at the
// line-search batch (11 x 1024 chains, N = 32, s = 4, float32) moves 91 MB,
// 27 us at the memory rate, and K2 at the solve pair 10 MB, 3 us; the
// first port (one thread per chain, every operand transposed to batch-last
// and back, the pivots in a global scratch, an IEEE division in every solve
// step) took 30x and 64x that, with 2.7 and 0.5 warps per SM.  The design
// is that of the fused kernels (fused.cuh):
//   - operands problem-major as PyTorch holds them; outputs leave through
//     the arena by coalesced stores, allocated in their final shape;
//   - 2s lanes per chain (K1: the forward and the backward pivot recursion
//     at once, the s columns of a message on s lanes, pivot_sweeps) or per
//     pair of chains (K2: one solve per lane-group parity, thomas), so a
//     warp carries 32 / 2s chains or pairs: 11264 chains are 2816 warps,
//     1024 pairs 256 (at s = 6 two per warp, its last 8 lanes repeating
//     lanes 0-7: fused.cuh group_lane);
//   - pivots and factors keep the reciprocals of their diagonal (chol_r):
//     every solve step multiplies;
//   - K1, after the sweeps: the warp's (chain, edge) items over its 32
//     lanes, each the 2s x 2s joint inverse of one edge, side by side (at
//     s = 6 from s x s Schur complements: fused.cuh edge_covariance_r);
//   - the arena: K1 keeps both pivot arrays of the warp's chains, K2 its
//     systems, right-hand sides, factors and solutions, in shared memory,
//     or in a global scratch for a chain too long for it (same code); each
//     chain's arrays slot_pitch apart, so that the few chains a warp
//     serves fall on different banks.
// The layout was chosen on an H100 (PERF.md, section 6).  K1 reads D and B
// through L1 in 16-byte pieces: its arena is then the pivots alone, 17.7 KB
// per warp in float32, and 12 warps share an SM (0.136 ms at the flagship);
// staging D and B in the arena too took 34.8 KB per warp, 6 warps per SM and
// 0.176 ms.  A block is one warp: 2 and 4 warps a block measured the same,
// and one is the finest grain for the SM to pack.  K2 fits 3 warps per SM
// in float32, so its 256 warps are one wave.  Warps in flight are what hides
// a sweep step's latency, so the SM's shared memory goes to the arenas.  No
// carveout is asked for: CUDA sizes it so that shared memory does not limit
// occupancy (K1 took the same time with a maximum-shared hint), and L1
// keeps what the 12 arenas leave.  D and B pass through it from L2; each
// block is read by the sweeps and once more by its edge.
// Every output word is written by one lane, in a fixed order: the same bits
// on every launch.
#pragma once

#include <atomic>
#include <cstdint>

#include "fused.cuh"

namespace gvi {

// Chains (K1) or pairs (K2) of one warp: 2s lanes each.
template <int S>
struct PerWarp {
  static constexpr int value = kWarp / (2 * S);
};

// Values from one of a warp's `slots` arrays of `base` values to the next:
// padded so that the arrays start 32 / slots banks apart, and the loads or
// stores of a sweep step, one word per array, fall on different banks.
template <typename T>
__host__ __device__ constexpr int64_t slot_pitch(int64_t base, int slots) {
  constexpr int64_t kBank = 32 * 4 / sizeof(T);   // values per bank row
  return base + ((kBank / slots - base) % kBank + kBank) % kBank;
}

// Arena of one K1 warp, in values of T: F and G of its C chains, n blocks
// each, slot_pitch apart (kernels/chain.py gbp_warp_elems is the wrapper's
// copy).
template <typename T, int S>
__host__ __device__ constexpr int64_t gbp_warp_elems(int64_t n) {
  constexpr int C = PerWarp<S>::value, M = Pitch<S>::kMat;
  return C * 2 * slot_pitch<T>(n * M, C);
}

// Arena of one K2 warp: for each of its 2C systems (system 0 of its C
// pairs, then system 1) D, then B, then the factors L, as n, n - 1 and n
// blocks, then the right-hand side and the solution as n vectors, each
// array slot_pitch apart (kernels/chain.py solve_warp_elems).
template <typename T, int S>
__host__ __device__ constexpr int64_t solve_warp_elems(int64_t n) {
  constexpr int C2 = 2 * PerWarp<S>::value, M = Pitch<S>::kMat;
  constexpr int V = Pitch<S>::kVec;
  return C2 * (2 * slot_pitch<T>(n * M, C2) + slot_pitch<T>((n - 1) * M, C2) +
               2 * slot_pitch<T>(n * V, C2));
}

// The block's (one warp's) arena: in dynamic shared memory, or its slice
// of scratch.
template <typename T>
__device__ __forceinline__ T* warp_arena(T* scratch, int64_t elems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return scratch == nullptr ? reinterpret_cast<T*>(smem_raw)
                            : scratch + blockIdx.x * elems;
}

template <typename T, int S>
__global__ void __launch_bounds__(kWarp)
gbp_kernel(const T* __restrict__ diag, const T* __restrict__ off,
           T* __restrict__ covd, T* __restrict__ covo, T* __restrict__ ld_out,
           T* __restrict__ scratch, int nb, int n) {
  constexpr int M = Pitch<S>::kMat, SS = S * S, C = PerWarp<S>::value;
  const int lane = threadIdx.x;
  const int64_t b0 = (int64_t)blockIdx.x * C;   // the warp's first chain
  const int valid = (int)min((int64_t)C, nb - b0);
  const int64_t cp = slot_pitch<T>(n * M, C);
  T* fpiv = warp_arena(scratch, gbp_warp_elems<T, S>(n));
  T* gpiv = fpiv + C * cp;
  const int64_t mats = (int64_t)n * SS, offs = (int64_t)(n - 1) * SS;
  // D and B stay in device memory, read through L1 in 16-byte pieces
  auto blocks = [&](int q) {
    return ChainBlocks<T, S, SS>{diag + (b0 + q) * mats, off + (b0 + q) * offs};
  };

  // ---- both pivot recursions of every chain, 2s lanes each; a lane past
  // the last chain, or past the warp's whole lane groups (s = 6), repeats
  // another (same values to the same words) --------------------------------
  const int gl = group_lane<S>(lane);
  const int c = min(gl / (2 * S), valid - 1);
  const T ld = pivot_sweeps<T, S, true>(blocks(c), n, lane, fpiv + c * cp,
                                        gpiv + c * cp);
  if (lane == gl && gl % (2 * S) == 0 && gl / (2 * S) < valid)
    ld_out[b0 + c] = ld;

  // ---- the edges, one (chain, edge) item per lane and turn: the record is
  // staged where the item's own pivots were (no other item reads F_i or
  // G_{i+1}): Sig_ii in F_i, Sig_{i,i+1} in G_{i+1}, the last state's
  // Sig_jj in F_{N-1} ------------------------------------------------------
  const int edges = n - 1;
  if (edges == 0 && lane < valid) {
    T f[S][S], l[S][S], rd[S], inv[S][S];
    load_mat(fpiv + lane * cp, 1, f);
    chol_r(f, l, rd);
    inv_from_chol_r(l, rd, inv);
    store_mat(fpiv + lane * cp, 1, inv);
  }
  for (int e = lane; e < valid * edges; e += kWarp) {
    const int q = e / edges, i = e % edges;
    T* fq = fpiv + q * cp;
    T* gq = gpiv + q * cp;
    T fp[S][S], g[S][S], bo[S][S], cii[S][S], cjj[S][S], cij[S][S];
    load_mat(fq + i * M, 1, fp);
    load_mat(gq + (i + 1) * M, 1, g);
    blocks(q).off(i, 0, bo);
    edge_covariance_r(fp, g, bo, cii, cjj, cij);
    store_mat(fq + i * M, 1, cii);
    store_mat(gq + (i + 1) * M, 1, cij);
    if (i == edges - 1) store_mat(fq + (i + 1) * M, 1, cjj);
  }
  __syncwarp();

  // ---- out, chain by chain --------------------------------------------
  for (int q = 0; q < valid; ++q) {
    copy_out<T, SS>(covd + (b0 + q) * mats, fpiv + q * cp, M, n, lane, kWarp);
    copy_out<T, SS>(covo + (b0 + q) * offs, gpiv + q * cp + M, M, edges,
                    lane, kWarp);
  }
}

// Pair u solves system 0 (d0, o0, v0 -> x0) and, for u < units1, system 1
// (d1, o1, v1 -> x1); v1 == v0 is one right-hand side for both.
template <typename T, int S>
__global__ void __launch_bounds__(kWarp)
solve_kernel(const T* __restrict__ d0, const T* __restrict__ o0,
             const T* v0, T* __restrict__ x0,
             const T* __restrict__ d1, const T* __restrict__ o1,
             const T* v1, T* __restrict__ x1,
             T* __restrict__ scratch, int units, int units1, int n) {
  constexpr int M = Pitch<S>::kMat, V = Pitch<S>::kVec, SS = S * S;
  constexpr int C = PerWarp<S>::value;
  const int lane = threadIdx.x;
  const int64_t u0 = (int64_t)blockIdx.x * C;   // the warp's first pair
  const int valid = (int)min((int64_t)C, units - u0);
  const int valid1 = (int)max((int64_t)0, min((int64_t)valid, units1 - u0));
  constexpr int C2 = 2 * C;
  const int64_t pitch_d = slot_pitch<T>(n * M, C2);
  const int64_t pitch_b = slot_pitch<T>((n - 1) * M, C2);
  const int64_t pitch_v = slot_pitch<T>(n * V, C2);
  T* dg = warp_arena(scratch, solve_warp_elems<T, S>(n));
  T* og = dg + C2 * pitch_d;
  T* lf = og + C2 * pitch_b;
  T* vv = lf + C2 * pitch_d;
  T* xx = vv + C2 * pitch_v;
  const int64_t mats = (int64_t)n * SS, offs = (int64_t)(n - 1) * SS;
  const int64_t vecs = (int64_t)n * S;
  const bool in_smem = scratch == nullptr, one_rhs = v1 == v0;

  // ---- stage: system 0 of the warp's pairs in slots 0..C-1, system 1 in
  // C..2C-1; each operand read once ----------------------------------------
  for (int q = 0; q < valid; ++q) {
    const int64_t u = u0 + q;
    copy_in_async<T, SS>(dg + q * pitch_d, M, d0 + u * mats, n, lane, kWarp,
                         in_smem);
    copy_in_async<T, SS>(og + q * pitch_b, M, o0 + u * offs, n - 1, lane,
                         kWarp, in_smem);
    copy_in_async<T, S>(vv + q * pitch_v, V, v0 + u * vecs, n, lane, kWarp,
                        in_smem);
    if (q >= valid1) continue;
    copy_in_async<T, SS>(dg + (C + q) * pitch_d, M, d1 + u * mats, n, lane,
                         kWarp, in_smem);
    copy_in_async<T, SS>(og + (C + q) * pitch_b, M, o1 + u * offs, n - 1,
                         lane, kWarp, in_smem);
    if (!one_rhs)
      copy_in_async<T, S>(vv + (C + q) * pitch_v, V, v1 + u * vecs, n, lane,
                          kWarp, in_smem);
  }
  async_commit();
  async_wait<0>();
  __syncwarp();

  // ---- both sweeps of every system, S lanes each.  A lane past the last
  // pair, or past the warp's whole lane groups (s = 6), repeats another
  // (same values to the same words); side 1 of a pair without a system 1
  // solves system 0 again into a slot nobody reads ----------------------
  const Lanes<S> g(lane);
  const int q = min(group_lane<S>(lane) / (2 * S), valid - 1);
  const int slot = g.side * C + q;
  const int src = g.side && q < valid1 ? slot : q;
  thomas<T, S, false>(dg + src * pitch_d, og + src * pitch_b,
                      vv + (one_rhs ? q : src) * pitch_v,
                      lf + slot * pitch_d, xx + slot * pitch_v, n, g);

  for (int k = 0; k < valid; ++k) {
    copy_out<T, S>(x0 + (u0 + k) * vecs, xx + k * pitch_v, V, n, lane, kWarp);
    if (k < valid1)
      copy_out<T, S>(x1 + (u0 + k) * vecs, xx + (C + k) * pitch_v, V, n,
                     lane, kWarp);
  }
}

// One-warp blocks over `count` chains (K1) or pairs (K2).
template <int S>
inline int chain_blocks(int64_t count) {
  return static_cast<int>((count + PerWarp<S>::value - 1) /
                          PerWarp<S>::value);
}

// The kernel's dynamic shared memory limit raised to the most a block may
// ask for, once per device: `done` (one bit per device) belongs to the
// kernel's instance.  A cudaFuncSetAttribute per launch would sit on the
// host's path to every launch.
template <typename Kernel>
inline cudaError_t allow_smem_once(Kernel kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t attr = allow_smem(kernel, kMaxSmem);
  if (attr == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return attr;
}

template <typename T, int S>
int launch_gbp(const void* diag, const void* off, void* covd, void* covo,
               void* ld, void* scratch, int nb, int n, long long arena,
               cudaStream_t st) {
  // the wrapper sized the arena: both sides must lay a warp out alike
  if (n < 1 || arena != gbp_warp_elems<T, S>(n)) return -1;
  // read through L1 in 16-byte pieces (load_block_vec)
  if (((reinterpret_cast<uintptr_t>(diag) |
        reinterpret_cast<uintptr_t>(off)) & 15) != 0)
    return -1;
  const size_t smem = scratch == nullptr ? sizeof(T) * arena : 0;
  if (smem > kMaxSmem) return -1;
  static std::atomic<uint64_t> smem_allowed{0};
  const cudaError_t prep = allow_smem_once(gbp_kernel<T, S>, smem_allowed);
  if (prep != cudaSuccess) return static_cast<int>(prep);
  gbp_kernel<T, S><<<chain_blocks<S>(nb), kWarp, smem, st>>>(
      static_cast<const T*>(diag), static_cast<const T*>(off),
      static_cast<T*>(covd), static_cast<T*>(covo), static_cast<T*>(ld),
      static_cast<T*>(scratch), nb, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch_solve(const void* const* ops, void* scratch, int units, int units1,
                 int n, long long arena, cudaStream_t st) {
  if (n < 1 || arena != solve_warp_elems<T, S>(n)) return -1;
  const size_t smem = scratch == nullptr ? sizeof(T) * arena : 0;
  if (smem > kMaxSmem) return -1;
  static std::atomic<uint64_t> smem_allowed{0};
  const cudaError_t prep = allow_smem_once(solve_kernel<T, S>, smem_allowed);
  if (prep != cudaSuccess) return static_cast<int>(prep);
  solve_kernel<T, S><<<chain_blocks<S>(units), kWarp, smem, st>>>(
      static_cast<const T*>(ops[0]), static_cast<const T*>(ops[1]),
      static_cast<const T*>(ops[2]), static_cast<T*>(const_cast<void*>(ops[3])),
      static_cast<const T*>(ops[4]), static_cast<const T*>(ops[5]),
      static_cast<const T*>(ops[6]), static_cast<T*>(const_cast<void*>(ops[7])),
      static_cast<T*>(scratch), units, units1, n);
  return static_cast<int>(cudaGetLastError());
}


// The instances of chain_wide.cu: s = 1 (the kernels above, 16 chains or
// pairs a warp) and s = 14 (gbp_wide_kernel, solve_wide_kernel: a warp a
// chain or pair), the same arguments and return values as launch_gbp /
// launch_solve with the dtype code (0 float32, 1 float64) and s in front.
int launch_gbp_s1_s14(int dtype, int s, const void* diag, const void* off,
                      void* covd, void* covo, void* ld, void* scratch, int nb,
                      int n, long long arena, cudaStream_t st);
int launch_solve_s1_s14(int dtype, int s, const void* const* ops,
                        void* scratch, int units, int units1, int n,
                        long long arena, cudaStream_t st);

}  // namespace gvi
