// sig_vjp: the full VJP of the forward k-space signal operator on Hopper
// (sm_90a), in one pass.
//
// Replaces the TPU kernel `_sig_vjp_kernel` (launched by
// `signal_vjp_planes`, mrphy_tpu/ops/signal_pallas.py). Given the
// cotangent rows g2 = [ḡ_re; ḡ_im] of the signal and the forward's
// coil-weighted spins w2, for every spin m and sample t (factors C, S of
// sig_common.cuh, g2q = [ḡ_im; −ḡ_re]):
//   P = Σ_r w2[r, m]·g2[r, t],  Q = Σ_r w2[r, m]·g2q[r, t],
//   dφ = 2π(P·S − Q·C)            (the cotangent of the phase in cycles)
// and it returns
//   XR[r, m] = Σ_t C·g2[r, t],  XS[r, m] = Σ_t S·g2[r, t]  (the linear
//     adjoint's factors; the caller forms ∂/∂w2 and the M/sens product
//     rule from them),
//   dloc[:, m] = Σ_t dφ·k_t,  ddf[m] = Σ_t dφ·t_t,
//   di2[m] = −Σ_t t_t·(C·P + S·Q)   (w.r.t. 1/T2*; the caller chains
//     ∂/∂T2* = −di2/T2*²),
//   dk[:, t] = Σ_m dφ·x_m            (the trajectory's gradient).
// P, Q, dloc, ddf, di2 and dk are linear in (P, Q), so a coil group's
// rows give its share of each; the wrapper sums the groups' shares.
//
// What bounds it on the H100: arithmetic, about twice sig_adj's per
// spin-sample (the P/Q dot products, the row accumulators, dφ and its four
// sums, and dk's reduction over spins). Device-memory traffic is the
// inputs, the per-spin outputs and the dk partial rows below.
//
// Design: one thread per spin, grid (nblk, N·groups). The TPU kernel
// accumulates the per-spin outputs across a sequential grid of time tiles
// and streams one dk partial per (spin tile, time tile); here each thread
// walks all samples itself (per-spin sums in registers) and dk — a sum
// over spins at every sample — is reduced across the block: a warp
// shuffle per sample, one value per warp into shared memory, then the
// warps' values summed in warp order into the block's own partial row of
// dk_part (N, groups·nblk, 3, nT); the wrapper sums those rows in a fixed
// order (no atomics). A block walks several spin tiles (tile = blockIdx.x,
// + gridDim.x, ...; the wrapper picks nblk so that about two blocks per SM
// are in flight), so dk_part stays small: 50 MB at 64³ spins × 16,384
// samples in float32 where one row per spin tile would take 201 MB. The
// block stages kTileT samples of k and of its group's g2 rows in shared
// memory. Threads past the ragged edge carry w2 = 0, so dφ = 0: they take
// part in the shuffles and store nothing.
#include "sig_common.cuh"

namespace mrphy_sig {

constexpr int kTileT8 = 128;  // samples staged per shared-memory pass
constexpr int kWarps = kThreads / 32;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
sig_vjp_kernel(const T* __restrict__ g2, const T* __restrict__ w2,
               const T* __restrict__ pos, int64_t pos_bs,
               const T* __restrict__ df, int64_t df_bs,
               const T* __restrict__ it2, int64_t it2_bs,
               const T* __restrict__ k, int64_t k_bs, T* __restrict__ XR,
               T* __restrict__ XS, T* __restrict__ dloc,
               T* __restrict__ ddf, T* __restrict__ di2,
               T* __restrict__ dk, int64_t N, int64_t nM, int64_t nT,
               int64_t nC, T dt) {
  constexpr int G = R / 2;
  __shared__ T sk[3][kTileT8];
  __shared__ __align__(16) T sg[kTileT8][R];
  __shared__ T red[kWarps][3][kTileT8];

  const int64_t ng = (nC + G - 1) / G;
  const int64_t n = blockIdx.y / ng, g = blockIdx.y % ng;
  const Group gr = group_of<R>(g, nC);
  const bool has_df = df != nullptr, relax = it2 != nullptr;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* k_n = k + n * k_bs;
  const T* g_n = g2 + n * 2 * nC * nT;
  const T* w_n = w2 + n * 2 * nC * nM;
  const T* p_n = pos + n * pos_bs;
  T* dk_b = dk + ((n * ng + g) * gridDim.x + blockIdx.x) * 3 * nT;
  const T two_pi = T(6.283185307179586);

  const int64_t tiles = (nM + kThreads - 1) / kThreads;
  bool first = true;  // the first spin tile writes dk_b, later ones add
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t m = tile * kThreads + threadIdx.x;
    const bool active = m < nM;
    T x = 0, y = 0, z = 0, d = 0, i2 = 0, w[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t row = row_of<R>(j, gr, nC);
      w[j] = (active && row >= 0) ? w_n[row * nM + m] : T(0);
    }
    if (active) {
      x = p_n[m];
      y = p_n[nM + m];
      z = p_n[2 * nM + m];
      if (has_df) d = df[n * df_bs + m];
      if (relax) i2 = it2[n * it2_bs + m];
    }
    T aR[R], aS[R], dlx = 0, dly = 0, dlz = 0, adf = 0, ai2 = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) aR[j] = aS[j] = T(0);

    for (int64_t t0 = 0; t0 < nT; t0 += kTileT8) {
      const int len = (int)(nT - t0 < kTileT8 ? nT - t0 : kTileT8);
      __syncthreads();  // the previous tile and its dk sums are consumed
      for (int i = threadIdx.x; i < kTileT8; i += kThreads)
        for (int a = 0; a < 3; ++a)
          sk[a][i] = i < len ? k_n[a * nT + t0 + i] : T(0);
      for (int e = threadIdx.x; e < kTileT8 * R; e += kThreads) {
        const int j = e / kTileT8, i = e % kTileT8;
        const int64_t row = row_of<R>(j, gr, nC);
        sg[i][j] = (i < len && row >= 0) ? g_n[row * nT + t0 + i] : T(0);
      }
      __syncthreads();
      for (int i = 0; i < len; ++i) {
        const T tt = T(t0 + i + 1) * dt;
        const T kx = sk[0][i], ky = sk[1][i], kz = sk[2][i];
        T C, S;
        factors(phase(x, y, z, d, has_df, kx, ky, kz, tt), tt, i2, relax, C,
                S);
        T P = 0, Q = 0;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          P = fma_(w[j], sg[i][j], P);
          aR[j] = fma_(C, sg[i][j], aR[j]);
          aS[j] = fma_(S, sg[i][j], aS[j]);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {  // g2q = [ḡ_im; −ḡ_re]
          Q = fma_(w[j], sg[i][G + j], Q);
          Q = fma_(-w[G + j], sg[i][j], Q);
        }
        const T dphi = two_pi * (P * S - Q * C);
        dlx = fma_(dphi, kx, dlx);
        dly = fma_(dphi, ky, dly);
        dlz = fma_(dphi, kz, dlz);
        adf = fma_(dphi, tt, adf);
        ai2 = fma_(tt, C * P + S * Q, ai2);
        T vx = dphi * x, vy = dphi * y, vz = dphi * z;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          vx += __shfl_down_sync(0xffffffffu, vx, o);
          vy += __shfl_down_sync(0xffffffffu, vy, o);
          vz += __shfl_down_sync(0xffffffffu, vz, o);
        }
        if (lane == 0) {
          red[warp][0][i] = vx;
          red[warp][1][i] = vy;
          red[warp][2][i] = vz;
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < 3 * kTileT8; e += kThreads) {
        const int a = e / kTileT8, i = e % kTileT8;
        if (i >= len) continue;
        T s = red[0][a][i];
        for (int v = 1; v < kWarps; ++v) s += red[v][a][i];
        T* dst = dk_b + a * nT + t0 + i;
        *dst = first ? s : *dst + s;
      }
    }
    first = false;
    if (!active) continue;
    const int64_t base = n * 2 * nC * nM + m;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t row = row_of<R>(j, gr, nC);
      if (row < 0) continue;
      XR[base + row * nM] = aR[j];
      XS[base + row * nM] = aS[j];
    }
    const int64_t gn = g * N + n;  // the group's share, (ng, N, ...)
    dloc[(gn * 3 + 0) * nM + m] = dlx;
    dloc[(gn * 3 + 1) * nM + m] = dly;
    dloc[(gn * 3 + 2) * nM + m] = dlz;
    if (has_df) ddf[gn * nM + m] = adf;
    if (relax) di2[gn * nM + m] = -ai2;
  }
  if (first)  // a block with no spin tile: a zero partial row
    for (int64_t e = threadIdx.x; e < 3 * nT; e += kThreads) dk_b[e] = T(0);
}

template <typename T>
int launch_sig_vjp(const void* const* in, void* const* out,
                   const int64_t* bs, int64_t N, int64_t nM, int64_t nT,
                   int64_t nC, int64_t nblk, double dt, void* stream) {
  if (N <= 0 || nM <= 0 || nT <= 0 || nC <= 0 || nblk <= 0)
    return cudaErrorInvalidValue;
  return dispatch_rows(nC, [&](auto r) {
    constexpr int R = decltype(r)::value;
    const int64_t ny = N * groups_of<R>(nC);
    if (ny > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)nblk, (unsigned)ny);
    sig_vjp_kernel<T, R><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)in[0], (const T*)in[1], (const T*)in[2], bs[0],
        (const T*)in[3], bs[1], (const T*)in[4], bs[2], (const T*)in[5],
        bs[3], (T*)out[0], (T*)out[1], (T*)out[2], (T*)out[3], (T*)out[4],
        (T*)out[5], N, nM, nT, nC, (T)dt);
    return (int)cudaGetLastError();
  });
}

}  // namespace mrphy_sig

// Inputs (g2, w2, pos, df, it2, k); outputs XR, XS (N, 2nC, nM), dloc
// (groups, N, 3, nM), ddf, di2 (groups, N, nM) and dk (N, groups·nblk, 3,
// nT), groups = ceil(nC / 8) beyond 4 coils, else 1; the batch strides of
// pos, df, it2 and k (0 = broadcast), N, nM, nT, nC, nblk, dt. df/ddf and
// it2/di2 are NULL when absent. Returns the cudaError_t of the launch.
#define MRPHY_SIG_VJP_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* g2, const void* w2, const void* pos,      \
                      const void* df, const void* it2, const void* k,       \
                      void* XR, void* XS, void* dloc, void* ddf, void* di2, \
                      void* dk, int64_t pos_bs, int64_t df_bs,              \
                      int64_t it2_bs, int64_t k_bs, int64_t N, int64_t nM,  \
                      int64_t nT, int64_t nC, int64_t nblk, double dt,      \
                      void* stream) {                                       \
    const void* in[6] = {g2, w2, pos, df, it2, k};                          \
    void* const out[6] = {XR, XS, dloc, ddf, di2, dk};                      \
    const int64_t bs[4] = {pos_bs, df_bs, it2_bs, k_bs};                    \
    return mrphy_sig::launch_sig_vjp<T>(in, out, bs, N, nM, nT, nC, nblk,   \
                                        dt, stream);                        \
  }

MRPHY_SIG_VJP_ENTRY(mrphy_sig_vjp_f32, float)
MRPHY_SIG_VJP_ENTRY(mrphy_sig_vjp_f64, double)
