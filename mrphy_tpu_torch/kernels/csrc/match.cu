// match: the fused matched filter of MRF dictionary matching on Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_match_kernel` (launched by `match_core`,
// mrphy_tpu/ops/mrf_pallas.py). For every probe (voxel) it scores every
// unit-norm atom, |⟨d, x⟩|² = (Dre·x)² + (Dim·x)² for re/im pair signals
// (Dim the i-rotated atoms) or the signed Dre·x for real ones, and keeps
// the running maximum and its first atom index. The (nV, nA) score matrix
// is never stored: only idx (nV,) and best (nV,) reach device memory.
//
// What bounds it on the H100: arithmetic. Two products of depth r per
// (voxel, atom): 4.2e12 operations at 1,048,576 voxels × 62,325 atoms × r
// 16, ~62 ms at the card's float32 peak outside the tensor cores (the
// products are float32 FMAs on the CUDA cores: no TF32, no library GEMM).
//
// Design. A block owns 64 voxels and walks all atoms in tiles of 64; its
// 256 threads form a 16 × 16 grid, each thread 4 voxels × 4 atoms of the
// tile's scores in registers (two 4 × 4 accumulators for pair signals).
// The depth r is walked in chunks of 16: the block stages the chunk of its
// voxels and of the tile's atoms (real and rotated) into shared memory,
// depth-major, then every thread accumulates its 4 × 4 outer products
// with fma. After the tile's last chunk each thread takes the maximum of
// its 4 atoms per voxel (first index on ties), the 16 threads that share
// the voxels combine theirs by shuffles (greater score, or equal score
// and lower index, wins) and the block's running best per voxel is
// replaced only by a strictly greater tile maximum: tiles are visited in
// increasing atom order, so the result is the first occurrence of the
// maximum, jnp.argmax's tie rule (mrf_pallas.py:100-108). Atoms past nA
// score −inf; the depth past r is zero-padded. Sums are taken in another
// order than the plain version's matrix product (cuBLAS), so scores agree
// to rounding and near-tied atoms may swap.
#include <cuda_runtime.h>

#include <cstdint>
#include <math_constants.h>

namespace mrphy {
namespace match {

constexpr int kBV = 64;           // voxels per block
constexpr int kBA = 64;           // atoms per tile
constexpr int kKC = 16;           // depth per staged chunk
constexpr int kTV = 4, kTA = 4;   // voxels × atoms per thread
constexpr int kThreads = (kBV / kTV) * (kBA / kTA);  // 256
constexpr int kLd = kBV + 4;      // padded row of a staged chunk

template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() {
  return -CUDART_INF_F;
}
template <>
__device__ __forceinline__ double neg_inf<double>() {
  return -CUDART_INF;
}

template <typename T, bool PAIR>
__global__ void __launch_bounds__(kThreads)
match_kernel(const T* __restrict__ dre, const T* __restrict__ dim,
             const T* __restrict__ x, int32_t* __restrict__ idx,
             T* __restrict__ best, int64_t nA, int64_t nV, int64_t r) {
  __shared__ __align__(16) T xs[kKC * kLd];
  __shared__ __align__(16) T rs[kKC * kLd];
  __shared__ __align__(16) T is[PAIR ? kKC * kLd : 1];
  const int tx = threadIdx.x % (kBA / kTA);  // atoms
  const int ty = threadIdx.x / (kBA / kTA);  // voxels
  const int64_t v0 = (int64_t)blockIdx.x * kBV;
  T bv[kTV];
  int64_t bi[kTV];
  for (int i = 0; i < kTV; ++i) {
    bv[i] = neg_inf<T>();
    bi[i] = 0;
  }
  for (int64_t a0 = 0; a0 < nA; a0 += kBA) {
    T sre[kTV][kTA], sim[kTV][kTA];
    for (int i = 0; i < kTV; ++i)
      for (int j = 0; j < kTA; ++j) sre[i][j] = sim[i][j] = T(0);
    for (int64_t k0 = 0; k0 < r; k0 += kKC) {
      __syncthreads();  // the previous chunk is consumed
      // stage the chunk depth-major: consecutive threads read consecutive
      // depths of one row
      for (int e = threadIdx.x; e < kBV * kKC; e += kThreads) {
        const int row = e / kKC, kk = e % kKC;
        const int64_t k = k0 + kk, v = v0 + row, a = a0 + row;
        xs[kk * kLd + row] = (k < r && v < nV) ? x[v * r + k] : T(0);
        rs[kk * kLd + row] = (k < r && a < nA) ? dre[a * r + k] : T(0);
        if (PAIR)
          is[kk * kLd + row] = (k < r && a < nA) ? dim[a * r + k] : T(0);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        T xv[kTV], ar[kTA], ai[kTA];
        for (int i = 0; i < kTV; ++i) xv[i] = xs[kk * kLd + ty * kTV + i];
        for (int j = 0; j < kTA; ++j) {
          ar[j] = rs[kk * kLd + tx * kTA + j];
          if (PAIR) ai[j] = is[kk * kLd + tx * kTA + j];
        }
        for (int i = 0; i < kTV; ++i)
          for (int j = 0; j < kTA; ++j) {
            sre[i][j] = fma(xv[i], ar[j], sre[i][j]);
            if (PAIR) sim[i][j] = fma(xv[i], ai[j], sim[i][j]);
          }
      }
    }
    // this tile's best atom per voxel: first the thread's 4 atoms, then
    // the 16 threads that share the voxels (lanes tx of one half-warp)
    for (int i = 0; i < kTV; ++i) {
      T m = neg_inf<T>();
      int64_t mi = 0;
      for (int j = 0; j < kTA; ++j) {
        const int64_t a = a0 + tx * kTA + j;
        const T s = a < nA ? (PAIR ? sre[i][j] * sre[i][j] +
                                         sim[i][j] * sim[i][j]
                                   : sre[i][j])
                           : neg_inf<T>();
        if (s > m || j == 0) {
          m = s;
          mi = a;
        }
      }
      for (int o = (kBA / kTA) / 2; o > 0; o >>= 1) {
        const T om = __shfl_xor_sync(0xffffffffu, m, o);
        const int64_t oi = __shfl_xor_sync(0xffffffffu, mi, o);
        if (om > m || (om == m && oi < mi)) {
          m = om;
          mi = oi;
        }
      }
      if (m > bv[i]) {
        bv[i] = m;
        bi[i] = mi;
      }
    }
  }
  if (tx == 0)
    for (int i = 0; i < kTV; ++i) {
      const int64_t v = v0 + ty * kTV + i;
      if (v < nV) {
        idx[v] = (int32_t)bi[i];
        best[v] = bv[i];
      }
    }
}

template <typename T>
int launch_match(const T* dre, const T* dim, const T* x, int32_t* idx,
                 T* best, int64_t nA, int64_t nV, int64_t r, void* stream) {
  if (nA <= 0 || nV <= 0 || r <= 0 || nA > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t grid = (nV + kBV - 1) / kBV;
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (dim)
    match_kernel<T, true><<<(unsigned)grid, kThreads, 0,
                            (cudaStream_t)stream>>>(dre, dim, x, idx, best,
                                                    nA, nV, r);
  else
    match_kernel<T, false><<<(unsigned)grid, kThreads, 0,
                             (cudaStream_t)stream>>>(dre, dim, x, idx, best,
                                                     nA, nV, r);
  return (int)cudaGetLastError();
}

}  // namespace match
}  // namespace mrphy

// Unit-norm atoms dre (nA, r) and, for pair signals, their i-rotation dim
// (nA, r) (NULL for real signals), probes x (nV, r); outputs idx (nV,)
// int32 and best (nV,). Returns the cudaError_t of the launch (0 =
// success).
#define MRPHY_MATCH_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* dre, const void* dim, const void* x,       \
                      void* idx, void* best, int64_t nA, int64_t nV,         \
                      int64_t r, void* stream) {                              \
    return mrphy::match::launch_match<T>((const T*)dre, (const T*)dim,        \
                                         (const T*)x, (int32_t*)idx,          \
                                         (T*)best, nA, nV, r, stream);        \
  }

MRPHY_MATCH_ENTRY(mrphy_match_f32, float)
MRPHY_MATCH_ENTRY(mrphy_match_f64, double)
