// sig_adj: the conjugate-phase back-projection of the k-space signal
// operator on Hopper (sm_90a).
//
// Replaces the TPU kernel `_sig_adj_kernel` (launched by
// `signal_adj_planes`, mrphy_tpu/ops/signal_pallas.py). For every spin m
// and every signal row r (re/im of each coil):
//   XR[r, m] = Σ_t C[m, t]·s2[r, t],   XS[r, m] = Σ_t S[m, t]·s2[r, t]
// with the factors C, S of sig_common.cuh. The caller combines them with
// the receive maps into the adjoint magnetization.
//
// What bounds it on the H100: arithmetic. Per spin-sample it forms the
// phase (4 multiplies, 3 adds), reduces it, takes sincospi and (with T2*)
// exp, and does 2R multiply-adds into the row accumulators. Device-memory
// traffic is the per-spin inputs, s2 and the outputs, O((nM + nT)·nC).
//
// Design: one thread per spin, grid (ceil(nM/256), N·groups). The TPU
// kernel accumulates across a sequential grid of time tiles; here each
// thread walks all samples itself, so its sums stay in registers and no
// block depends on another. The block stages kTileT samples of k and of
// its coil group's s2 rows in shared memory and every thread reads them
// as broadcasts (s2 row-major per sample, R values contiguous). Sums are
// fused multiply-adds in sample order. Threads past the ragged edge of the
// spins stage and synchronize but store nothing; samples past nT are
// staged as zeros. Templated on the scalar type (float; double for a
// tight check against JAX in float64) and on R, the accumulator rows.
#include "sig_common.cuh"

namespace mrphy_sig {

constexpr int kTileT = 256;  // samples staged per shared-memory pass

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
sig_adj_kernel(const T* __restrict__ s2, const T* __restrict__ pos,
               int64_t pos_bs, const T* __restrict__ df, int64_t df_bs,
               const T* __restrict__ it2, int64_t it2_bs,
               const T* __restrict__ k, int64_t k_bs, T* __restrict__ XR,
               T* __restrict__ XS, int64_t nM, int64_t nT, int64_t nC,
               T dt) {
  __shared__ T sk[3][kTileT];
  __shared__ __align__(16) T ss[kTileT][R];

  const int64_t ng = (nC + R / 2 - 1) / (R / 2);
  const int64_t n = blockIdx.y / ng;
  const Group gr = group_of<R>(blockIdx.y % ng, nC);
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool active = m < nM;
  const bool has_df = df != nullptr, relax = it2 != nullptr;
  const T* k_n = k + n * k_bs;
  const T* s_n = s2 + n * 2 * nC * nT;

  T x = 0, y = 0, z = 0, d = 0, i2 = 0;
  if (active) {
    const T* p = pos + n * pos_bs;
    x = p[m];
    y = p[nM + m];
    z = p[2 * nM + m];
    if (has_df) d = df[n * df_bs + m];
    if (relax) i2 = it2[n * it2_bs + m];
  }
  T accR[R], accS[R];
#pragma unroll
  for (int j = 0; j < R; ++j) accR[j] = accS[j] = T(0);

  for (int64_t t0 = 0; t0 < nT; t0 += kTileT) {
    const int len = (int)(nT - t0 < kTileT ? nT - t0 : kTileT);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < kTileT; i += kThreads)
      for (int a = 0; a < 3; ++a)
        sk[a][i] = i < len ? k_n[a * nT + t0 + i] : T(0);
    for (int e = threadIdx.x; e < kTileT * R; e += kThreads) {
      const int j = e / kTileT, i = e % kTileT;
      const int64_t row = row_of<R>(j, gr, nC);
      ss[i][j] = (i < len && row >= 0) ? s_n[row * nT + t0 + i] : T(0);
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < len; ++i) {
      const T tt = T(t0 + i + 1) * dt;
      T C, S;
      factors(phase(x, y, z, d, has_df, sk[0][i], sk[1][i], sk[2][i], tt),
              tt, i2, relax, C, S);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        accR[j] = fma_(C, ss[i][j], accR[j]);
        accS[j] = fma_(S, ss[i][j], accS[j]);
      }
    }
  }
  if (!active) return;
  const int64_t base = n * 2 * nC * nM + m;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t row = row_of<R>(j, gr, nC);
    if (row < 0) continue;
    XR[base + row * nM] = accR[j];
    XS[base + row * nM] = accS[j];
  }
}

template <typename T>
int launch_sig_adj(const void* const* in, void* XR, void* XS,
                   const int64_t* bs, int64_t N, int64_t nM, int64_t nT,
                   int64_t nC, double dt, void* stream) {
  if (N <= 0 || nM <= 0 || nT <= 0 || nC <= 0) return cudaErrorInvalidValue;
  return dispatch_rows(nC, [&](auto r) {
    constexpr int R = decltype(r)::value;
    const int64_t ny = N * groups_of<R>(nC);
    if (ny > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((nM + kThreads - 1) / kThreads),
                    (unsigned)ny);
    sig_adj_kernel<T, R><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)in[0], (const T*)in[1], bs[0], (const T*)in[2], bs[1],
        (const T*)in[3], bs[2], (const T*)in[4], bs[3], (T*)XR, (T*)XS, nM,
        nT, nC, (T)dt);
    return (int)cudaGetLastError();
  });
}

}  // namespace mrphy_sig

// Inputs (s2, pos, df, it2, k), the outputs XR, XS (N, 2nC, nM), the batch
// strides of pos, df, it2 and k (0 = broadcast), N, nM, nT, nC, dt. df and
// it2 are NULL when absent. Returns the cudaError_t of the launch.
#define MRPHY_SIG_ADJ_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* s2, const void* pos, const void* df,      \
                      const void* it2, const void* k, void* XR, void* XS,   \
                      int64_t pos_bs, int64_t df_bs, int64_t it2_bs,        \
                      int64_t k_bs, int64_t N, int64_t nM, int64_t nT,      \
                      int64_t nC, double dt, void* stream) {                \
    const void* in[5] = {s2, pos, df, it2, k};                              \
    const int64_t bs[4] = {pos_bs, df_bs, it2_bs, k_bs};                    \
    return mrphy_sig::launch_sig_adj<T>(in, XR, XS, bs, N, nM, nT, nC, dt,  \
                                        stream);                            \
  }

MRPHY_SIG_ADJ_ENTRY(mrphy_sig_adj_f32, float)
MRPHY_SIG_ADJ_ENTRY(mrphy_sig_adj_f64, double)
