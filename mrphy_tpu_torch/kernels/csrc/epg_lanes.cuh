// epg_lanes.cuh: a group of G lanes of a warp per atom, over the
// configuration orders, for the EPG adjoints on their lane route
// (spgr_bwd_lanes.cu: K15 `spgr_bwd`; cpmg_bwd_lanes.cu: K18 `cpmg_bwd`;
// xspgr_bwd_lanes.cu: K21 `xspgr_bwd` and K24 `xspgr_v_bwd`;
// xcpmg_bwd_lanes.cu: K27 `xcpmg_bwd` and K30 `xcpmg_v_bwd`).
//
// Layout. Lane l of a group (G = 8, 16 or 32, a power of two) holds orders
// k = l + i·G in slot i of each plane, i < M (M = ⌈K/G⌉, a template
// parameter, so every register array is indexed at compile time). Slots
// past K − 1 of a plane that the shift moves down (F− in the forward, F+
// in its transpose, for kshift > 0; the mirror otherwise) hold 0 at all
// times; a plane that moves up may carry values past K − 1, which nothing
// reads: every per-order step skips those slots. A block has kThreads
// threads, kThreads/G atoms. In shared memory an atom's state takes
// `stride` values, element (plane p, slot i, lane l) at (p·M + i)·G + l;
// the stride is padded by G (for G < 32) so that the groups of one warp
// fall on distinct banks.
//
// The spoiler's shift by s orders is a lane rotation by s (for s < G; a
// larger s runs in pieces of at most G − 1) through __shfl_sync within the
// group, plus a move by one slot where the rotation wraps; lane s − k gives
// the k = 0 crossing (F+(k) = conj F−(s − k)). Its transpose likewise. Only
// values move (and a sign flips), so each matches the plain versions'
// unit shifts bit for bit, as a sum of two values matches where the
// transpose crosses k = 0.
//
// Sums over the orders: each lane adds its own slots in slot order, then the
// group adds its lanes by __shfl_down_sync at offsets G/2, …, 1, so lane 0
// holds the sum; the plain versions take the same order
// (kernels/epg.py `_lane_sum`).
#pragma once

#include "spgr_common.cuh"

namespace mrphy {
namespace lanes {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;

// This lane's place: lane l of a group of G over K orders.
struct Group {
  int l, G, K;
  __device__ __forceinline__ int order(int i) const { return l + i * G; }
  __device__ __forceinline__ bool valid(int i) const { return l + i * G < K; }
};

// An atom's values in shared memory: planes of M slots of G lanes, padded.
__host__ __device__ constexpr int stride(int planes, int M, int G) {
  return planes * M * G + (G < 32 ? G : 0);
}

template <typename T>
__device__ __forceinline__ T shfl(T v, int src, int G) {
  return __shfl_sync(kFull, v, src, G);
}

// new(k) = old(k − s), 1 ≤ s < G; the orders below s get 0.
template <typename T, int M>
__device__ __forceinline__ void up(T (&x)[M], int s, const Group& g) {
  T t[M];
  const int src = (g.l - s) & (g.G - 1);
#pragma unroll
  for (int i = 0; i < M; ++i) t[i] = shfl(x[i], src, g.G);
  const bool wrap = g.l < s;
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = wrap ? (i > 0 ? t[i - 1] : T(0)) : t[i];
}

// new(k) = old(k + s), 1 ≤ s < G; from beyond the slots 0.
template <typename T, int M>
__device__ __forceinline__ void down(T (&x)[M], int s, const Group& g) {
  T t[M];
  const int src = (g.l + s) & (g.G - 1);
#pragma unroll
  for (int i = 0; i < M; ++i) t[i] = shfl(x[i], src, g.G);
  const bool wrap = g.l + s >= g.G;
#pragma unroll
  for (int i = 0; i < M; ++i)
    x[i] = wrap ? (i + 1 < M ? t[i + 1] : T(0)) : t[i];
}

// One piece (1 ≤ s < G) of the spoiler's shift of one pool: planes PU, PU+1
// (F+ re, im for kshift > 0) move up, PD, PD+1 down, and PU(k < s) =
// conj(old PD(s − k)); orders past K − 1 are dropped (PD takes the zeros
// past K − 1).
template <int PU, int PD, typename T, int P, int M>
__device__ __forceinline__ void shift_piece(T (&x)[P][M], int s,
                                            const Group& g) {
  const int src = (s - g.l) & (g.G - 1);
  const T cr = shfl(x[PD][0], src, g.G), ci = shfl(x[PD + 1][0], src, g.G);
  down(x[PD], s, g);
  down(x[PD + 1], s, g);
  up(x[PU], s, g);
  up(x[PU + 1], s, g);
  if (g.l < s) {
    x[PU][0] = cr;
    x[PU + 1][0] = -ci;
  }
}

// Its transpose: PU, PU+1 move down, PD, PD+1 up, and for 1 ≤ k ≤ s
// conj(old PU(s − k)) is added to PD(k).
template <int PU, int PD, typename T, int P, int M>
__device__ __forceinline__ void shift_piece_T(T (&h)[P][M], int s,
                                              const Group& g) {
  const int src = (s - g.l) & (g.G - 1);
  const T cr = shfl(h[PU][0], src, g.G), ci = shfl(h[PU + 1][0], src, g.G);
  down(h[PU], s, g);
  down(h[PU + 1], s, g);
  up(h[PD], s, g);
  up(h[PD + 1], s, g);
  if (g.l >= 1 && g.l <= s) {
    h[PD][0] = h[PD][0] + cr;
    h[PD + 1][0] = h[PD + 1][0] - ci;
  }
}

// The shift by kshift of the pool whose planes start at B (F+ re, F+ im,
// F− re, F− im at B … B + 3), or its transpose.
template <int B, bool TRANSPOSE, typename T, int P, int M>
__device__ __forceinline__ void shift_pool(T (&x)[P][M], int kshift,
                                           const Group& g) {
  int n = kshift > 0 ? kshift : -kshift;
  while (n > 0) {
    const int s = n < g.G ? n : g.G - 1;
    n -= s;
    if (kshift > 0) {
      if (TRANSPOSE)
        shift_piece_T<B, B + 2>(x, s, g);
      else
        shift_piece<B, B + 2>(x, s, g);
    } else {
      if (TRANSPOSE)
        shift_piece_T<B + 2, B>(x, s, g);
      else
        shift_piece<B + 2, B>(x, s, g);
    }
  }
}

// The group's sum of one value per lane, in the fixed order (lane 0 holds
// it).
template <typename T>
__device__ __forceinline__ T group_sum(T v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v = v + __shfl_down_sync(kFull, v, o, G);
  return v;
}

// The warp's sum over its groups of one value held by each group's lane 0
// (every other lane holds 0); lane 0 of the warp holds it.
template <typename T>
__device__ __forceinline__ T warp_groups_sum(T v, int G) {
  for (int o = 16; o >= G; o >>= 1) v = v + __shfl_down_sync(kFull, v, o);
  return v;
}

// Read an atom's state from shared memory (st: its slot) into registers.
template <typename T, int P, int M>
__device__ __forceinline__ void load(const T* st, T (&x)[P][M],
                                     const Group& g) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < M; ++i) x[p][i] = st[(p * M + i) * g.G + g.l];
}

template <typename T, int P, int M>
__device__ __forceinline__ void store(T* st, const T (&x)[P][M],
                                      const Group& g) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < M; ++i) st[(p * M + i) * g.G + g.l] = x[p][i];
}

// One element from device to shared memory without waiting
// (cp.async, completed by copy_wait); a plain copy in host builds.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
#endif
}

// Chunk j's checkpoint (planes·K rows of nA atoms, rows at src) of the
// block's atoms [a0, a0 + A) into slot 0 (the block's shared states, atom
// aa at slots + aa·stride), read coalesced along the atoms, every copy in
// flight at once; atoms past nA get 0. Every thread of the block takes
// part; the caller synchronises the block after it.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, T* slots,
                                      int64_t nA, int64_t a0, int lgA,
                                      int planes, int K, int M, int lg,
                                      int stride_atom) {
  const int G = 1 << lg, aa = threadIdx.x & ((1 << lgA) - 1);
  const int rstep = blockDim.x >> lgA, rows = planes * K;
  const int64_t a = a0 + aa;
  T* const dst = slots + aa * stride_atom;
  int row = threadIdx.x >> lgA, p = row / K, k = row - p * K;
  for (; row < rows; row += rstep) {
    T* const d = dst + (p * M + (k >> lg)) * G + (k & (G - 1));
    if (a < nA)
      copy_async(d, src + (int64_t)row * nA + a);
    else
      *d = T(0);
    for (k += rstep; k >= K; k -= K) ++p;
  }
  copy_wait();
}

// Shared memory of the block set to 0 (the slots past K − 1 stay so).
template <typename T>
__device__ __forceinline__ void zero(T* slots, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) slots[e] = T(0);
}

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v >> 1);
}

// G and M as the wrapper chose them (kernels/epg.py `adjoint_cfg`) for K
// orders.
inline bool valid_cfg(int64_t G, int64_t M, int64_t K) {
  return (G == 8 || G == 16 || G == 32) && M >= 1 && M * G >= K &&
         (M - 1) * G < K;
}

// S, the chunk states an atom keeps in shared memory (kernels/epg.py
// `lane_capacity`): those that fit 3 blocks an SM of 228 KB, 1 KB of each
// block reserved, at most 8.
inline int64_t max_states(int planes, int M, int G, int itemsize) {
  const int64_t slot = (int64_t)(kThreads / G) * stride(planes, M, G) *
                       itemsize;
  const int64_t s = (233472 / 3 - 1024) / slot;
  return s < 8 ? s : 8;
}

// Whether a block's dynamic shared memory fits the current device's
// opt-in limit per block.
inline bool smem_fits(size_t bytes) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return bytes <= (size_t)optin;
}

}  // namespace lanes
}  // namespace mrphy
