// sig_fwd: the forward k-space signal operator on Hopper (sm_90a).
//
// Replaces the TPU kernel `_sig_fwd_kernel` (launched by
// `signal_fwd_planes`, mrphy_tpu/ops/signal_pallas.py). For every sample t
// and every row r of the coil-weighted spins w2 (re/im of each coil):
//   U[r, t] = Σ_m w2[r, m]·C[m, t],   V[r, t] = Σ_m w2[r, m]·S[m, t]
// with the factors C, S of sig_common.cuh; the caller forms the signal
// s_re = U[:nC] − V[nC:], s_im = V[:nC] + U[nC:].
//
// What bounds it on the H100: arithmetic, as sig_adj (the same phase,
// sincospi, exp and 2R multiply-adds per spin-sample); device-memory
// traffic is O((nM + nT)·nC) plus the split partials below.
//
// Design: one thread per sample, grid (ceil(nT/256), nsplit, N·groups).
// The TPU kernel accumulates over a sequential grid of spin tiles into its
// output block; blocks on Hopper run in no order, so the spins are split
// over gridDim.y instead (nsplit is chosen by the wrapper so that enough
// blocks are in flight: 16,384 samples make only 64 blocks of 256), each
// split walks its spin tiles in order, and writes its own partial rows
// Upart/Vpart (nsplit, N, 2nC, nT); the wrapper sums them over the splits
// in a fixed order (no atomics). The block stages kTileS spins' location,
// Δf, 1/T2* and its coil group's w2 rows in shared memory; every thread
// reads them as broadcasts. Spins past nM are staged as zeros (w2 = 0
// adds nothing); threads past nT compute on zero k and store nothing.
#include "sig_common.cuh"

namespace mrphy_sig {

constexpr int kTileS = 256;  // spins staged per shared-memory pass

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
sig_fwd_kernel(const T* __restrict__ w2, const T* __restrict__ pos,
               int64_t pos_bs, const T* __restrict__ df, int64_t df_bs,
               const T* __restrict__ it2, int64_t it2_bs,
               const T* __restrict__ k, int64_t k_bs, T* __restrict__ Upart,
               T* __restrict__ Vpart, int64_t N, int64_t nM, int64_t nT,
               int64_t nC, T dt) {
  __shared__ __align__(16) T sp[kTileS][5];  // x, y, z, Δf, 1/T2*
  __shared__ __align__(16) T sw[kTileS][R];

  const int64_t ng = (nC + R / 2 - 1) / (R / 2);
  const int64_t n = blockIdx.z / ng;
  const Group gr = group_of<R>(blockIdx.z % ng, nC);
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool active = t < nT;
  const bool has_df = df != nullptr, relax = it2 != nullptr;
  const T* p_n = pos + n * pos_bs;
  const T* w_n = w2 + n * 2 * nC * nM;

  // this split's spin tiles: [tile0, tile1)
  const int64_t tiles = (nM + kTileS - 1) / kTileS;
  const int64_t per = (tiles + gridDim.y - 1) / gridDim.y;
  const int64_t tile0 = blockIdx.y * per;
  const int64_t tile1 = tile0 + per < tiles ? tile0 + per : tiles;

  T kx = 0, ky = 0, kz = 0;
  if (active) {
    const T* k_n = k + n * k_bs;
    kx = k_n[t];
    ky = k_n[nT + t];
    kz = k_n[2 * nT + t];
  }
  const T tt = T(t + 1) * dt;
  T accU[R], accV[R];
#pragma unroll
  for (int j = 0; j < R; ++j) accU[j] = accV[j] = T(0);

  for (int64_t tile = tile0; tile < tile1; ++tile) {
    const int64_t m0 = tile * kTileS;
    const int len = (int)(nM - m0 < kTileS ? nM - m0 : kTileS);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < kTileS; i += kThreads) {
      const bool in = i < len;
      const int64_t m = m0 + i;
      sp[i][0] = in ? p_n[m] : T(0);
      sp[i][1] = in ? p_n[nM + m] : T(0);
      sp[i][2] = in ? p_n[2 * nM + m] : T(0);
      sp[i][3] = (in && has_df) ? df[n * df_bs + m] : T(0);
      sp[i][4] = (in && relax) ? it2[n * it2_bs + m] : T(0);
    }
    for (int e = threadIdx.x; e < kTileS * R; e += kThreads) {
      const int j = e / kTileS, i = e % kTileS;
      const int64_t row = row_of<R>(j, gr, nC);
      sw[i][j] = (i < len && row >= 0) ? w_n[row * nM + m0 + i] : T(0);
    }
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      T C, S;
      factors(phase(sp[i][0], sp[i][1], sp[i][2], sp[i][3], has_df, kx, ky,
                    kz, tt),
              tt, sp[i][4], relax, C, S);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        accU[j] = fma_(sw[i][j], C, accU[j]);
        accV[j] = fma_(sw[i][j], S, accV[j]);
      }
    }
  }
  if (!active) return;
  const int64_t base = (blockIdx.y * N + n) * 2 * nC * nT + t;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t row = row_of<R>(j, gr, nC);
    if (row < 0) continue;
    Upart[base + row * nT] = accU[j];
    Vpart[base + row * nT] = accV[j];
  }
}

template <typename T>
int launch_sig_fwd(const void* const* in, void* Upart, void* Vpart,
                   const int64_t* bs, int64_t N, int64_t nM, int64_t nT,
                   int64_t nC, int64_t nsplit, double dt, void* stream) {
  if (N <= 0 || nM <= 0 || nT <= 0 || nC <= 0 || nsplit <= 0 ||
      nsplit > 65535)
    return cudaErrorInvalidValue;
  return dispatch_rows(nC, [&](auto r) {
    constexpr int R = decltype(r)::value;
    const int64_t nz = N * groups_of<R>(nC);
    if (nz > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((nT + kThreads - 1) / kThreads),
                    (unsigned)nsplit, (unsigned)nz);
    sig_fwd_kernel<T, R><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)in[0], (const T*)in[1], bs[0], (const T*)in[2], bs[1],
        (const T*)in[3], bs[2], (const T*)in[4], bs[3], (T*)Upart,
        (T*)Vpart, N, nM, nT, nC, (T)dt);
    return (int)cudaGetLastError();
  });
}

}  // namespace mrphy_sig

// Inputs (w2, pos, df, it2, k), the partial outputs Upart, Vpart (nsplit,
// N, 2nC, nT), the batch strides of pos, df, it2 and k (0 = broadcast), N,
// nM, nT, nC, nsplit, dt. df and it2 are NULL when absent. Every split
// writes all its rows: a split with no spins writes zeros. Returns the
// cudaError_t of the launch.
#define MRPHY_SIG_FWD_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* w2, const void* pos, const void* df,      \
                      const void* it2, const void* k, void* Upart,          \
                      void* Vpart, int64_t pos_bs, int64_t df_bs,           \
                      int64_t it2_bs, int64_t k_bs, int64_t N, int64_t nM,  \
                      int64_t nT, int64_t nC, int64_t nsplit, double dt,    \
                      void* stream) {                                       \
    const void* in[5] = {w2, pos, df, it2, k};                              \
    const int64_t bs[4] = {pos_bs, df_bs, it2_bs, k_bs};                    \
    return mrphy_sig::launch_sig_fwd<T>(in, Upart, Vpart, bs, N, nM, nT,    \
                                        nC, nsplit, dt, stream);            \
  }

MRPHY_SIG_FWD_ENTRY(mrphy_sig_fwd_f32, float)
MRPHY_SIG_FWD_ENTRY(mrphy_sig_fwd_f64, double)
