// rfgr_bwd: the reconstruction adjoint of rfgr_fwd on Hopper (sm_90a).
//
// Replaces the TPU kernel `_rfgr_bwd_kernel` (launched by
// `rfgr_bwd_planes`, mrphy_tpu/ops/pallas_kernels.py). For every spin it
// walks the pulse backwards, newest time chunk first: at the start of
// chunk j the state restarts from rfgr_fwd's chunk-end state chk[j] and
// the cotangent of chk[j] is added to the carried cotangent h; every step
// then rebuilds the field as rfgr_fwd does, undoes the step
// (bloch_step.cuh `rot_relax_bwd`: m₁ → m₀, h₁ → h₀, ∂L/∂b) and
//   - accumulates the per-spin field gradients in registers:
//     dloc += dbz·gr_t, ddfg += dbz,
//     db1_c += (dbx·rf_xc + dby·rf_yc, dby·rf_xc − dbx·rf_yc),
//     dvel += dbz·(gr_t·t), written once after chunk 0;
//   - contributes to the per-step waveform gradient rows, a sum over all
//     spins: dgr_k = Σ dbz·(loc_k + vel_k·t), and with B1
//     drf_xc = Σ (b1_xc·dbx + b1_yc·dby), drf_yc = Σ (b1_xc·dby − b1_yc·dbx),
//     without it Σ γ2πdt·dbx and Σ γ2πdt·dby (the same for every coil; the
//     wrapper broadcasts them). Kw = 3 + 2C rows with B1, 5 without.
//
// The row sums: each warp reduces its 32 spins by shuffles at every step
// and lane 0 parks the Kw sums in shared memory; after a stage of steps
// (kStageBwd, fewer where the Kw rows of many coils would not fit in
// shared memory) the block adds its 8 warps' sums and writes one partial
// row per block and step to dwf (N, nBlocks, nT, Kw). The wrapper sums
// over the blocks (torch.sum, a fixed order). No atomics: the order of the
// sum does not change from run to run. Threads past the ragged edge
// contribute 0 and take part in every shuffle and barrier.
//
// What bounds it on the H100: arithmetic. Per spin-step it rebuilds the
// field (as rfgr_fwd), does one sincos, one rsqrt and ~150 multiplies and
// adds of the adjoint step and the accumulators, plus 5·Kw shuffles and
// adds for the row sums: about 2.5–3× rfgr_fwd's work. Device-memory
// traffic is O(nS·(2·ntc + 1)) for chk and its cotangent, and the dwf
// partials, nBlocks·nT·Kw values per batch (82 MB at 1M spins × 1000 steps
// in f32 with one coil).
//
// Per-spin B1 values and db1 accumulators: for C ≤ 8 in register arrays
// sized by the template parameter MAXC ≥ C (instances 1, 2, 4, 8); for
// more coils (MAXC = 0, any C) B1 is read from device memory at every
// step, as rfgr_fwd reads it (2C values per spin, L1-resident), and db1
// is accumulated in place in its output. `nvcc -Xptxas -v` (CUDA 12.9,
// sm_90a), registers at MAXC 1 / 2 / 4 / 8 / 0: f32 64 / 74 / 114 / 125 /
// 64, f64 126 / 126 / 166 / 208 / 172; spills only in f32 at MAXC 1 (16
// bytes stored, 8 loaded) and 0 (24, 12).
//
// Built, like rfgr_fwd, without FMA contraction and in the plain version's
// order of operations (kernels/bloch.py `rfgr_bwd_torch`): the per-spin
// outputs reproduce the plain version; the rows differ from it only by the
// order of the sum over spins.
#include "bloch_step.cuh"

namespace mrphy {

constexpr int kStageBwd = 32;           // most waveform steps per pass
constexpr int kWarps = kThreads / 32;   // warps per block

// MAXC > 0: B1 and db1 in registers, C ≤ MAXC, kStageBwd steps staged per
// pass; MAXC == 0: any C, B1 and db1 in device memory, `stage_rt` ≤
// kStageBwd steps staged per pass.
template <typename T, int MAXC>
__global__ void __launch_bounds__(kThreads)
rfgr_bwd_kernel(const T* __restrict__ chk, const T* __restrict__ g,
                const T* __restrict__ rf2, const T* __restrict__ gr2,
                const T* __restrict__ loc, const T* __restrict__ dfg,
                const T* __restrict__ b1, const T* __restrict__ E,
                const T* __restrict__ e1_1, const T* __restrict__ g2pd,
                const T* __restrict__ vel, const T* __restrict__ tarr,
                T* __restrict__ dmi, T* __restrict__ dwf,
                T* __restrict__ dloc, T* __restrict__ ddfg,
                T* __restrict__ db1, T* __restrict__ dvel, int64_t nS,
                int64_t nT, int nC, int64_t tc, int stage_rt) {
  constexpr bool kRegB1 = MAXC > 0;
  constexpr int kRegC = kRegB1 ? MAXC : 1;
  const int stage = kRegB1 ? kStageBwd : stage_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool has_dfg = dfg != nullptr, has_b1 = b1 != nullptr;
  const bool relax = E != nullptr, has_vel = vel != nullptr;
  const int nR = 2 * nC;                  // rf rows
  const int Kin = nR + 3 + (has_vel ? 1 : 0);
  const int Kw = 3 + (has_b1 ? nR : 2);   // gradient rows
  T* wf = reinterpret_cast<T*>(smem_raw);  // (Kin, stage)
  T* wpart = wf + Kin * stage;              // (kWarps, stage, Kw)

  const int64_t n = blockIdx.y;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < nS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const T* rf_n = rf2 + n * nR * nT;
  const T* gr_n = gr2 + n * 3 * nT;
  const T* t_n = has_vel ? tarr + n * nT : nullptr;
  const int64_t p1 = n * nS + s;          // (N, nS) planes
  const int64_t p3 = n * 3 * nS + s;      // (N, 3, nS) planes
  const int64_t ntc = nT / tc;
  T* dwf_b = dwf + ((int64_t)n * gridDim.x + blockIdx.x) * nT * Kw;

  T lx = 0, ly = 0, lz = 0, vx = 0, vy = 0, vz = 0;
  T d = 0, gg = 0, E2 = 1, E1 = 1, e1 = 0, iE2 = 1, iE1 = 1;
  T b1x[kRegC], b1y[kRegC], ab1x[kRegC], ab1y[kRegC];
  const T* b1_s = nullptr;  // row r at b1_s[r * nS]
  T* db1_s = nullptr;       // the same for db1
#pragma unroll
  for (int c = 0; c < kRegC; ++c) {
    b1x[c] = 0;
    b1y[c] = 0;
    ab1x[c] = 0;
    ab1y[c] = 0;
  }
  if (active) {
    lx = loc[p3];
    ly = loc[p3 + nS];
    lz = loc[p3 + 2 * nS];
    if (has_vel) {
      vx = vel[p3];
      vy = vel[p3 + nS];
      vz = vel[p3 + 2 * nS];
    }
    if (has_dfg) d = dfg[p1];
    gg = g2pd[p1];
    if (relax) {
      E2 = E[p3];
      E1 = E[p3 + 2 * nS];
      e1 = e1_1[p1];
      iE2 = T(1) / E2;
      iE1 = T(1) / E1;
    }
    if (has_b1) {
      b1_s = b1 + n * nR * nS + s;
      db1_s = db1 + n * nR * nS + s;
      if constexpr (kRegB1) {
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < nC) {
            b1x[c] = b1_s[c * nS];
            b1y[c] = b1_s[(nC + c) * nS];
          }
      } else {
        for (int r = 0; r < nR; ++r) db1_s[r * nS] = 0;
      }
    }
  }

  T hx = 0, hy = 0, hz = 0;
  T alx = 0, aly = 0, alz = 0, adf = 0, avx = 0, avy = 0, avz = 0;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    T mx = 0, my = 0, mz = 0;
    if (active) {  // restart from the chunk's end state; add its cotangent
      const int64_t o = (n * ntc + j) * 3 * nS + s;
      mx = chk[o];
      my = chk[o + nS];
      mz = chk[o + 2 * nS];
      hx = hx + g[o];
      hy = hy + g[o + nS];
      hz = hz + g[o + 2 * nS];
    }
    const int64_t t_beg = j * tc;
    for (int64_t t1 = (j + 1) * tc; t1 > t_beg; t1 -= stage) {
      const int64_t t0 = t1 - stage > t_beg ? t1 - stage : t_beg;
      const int len = (int)(t1 - t0);
      __syncthreads();  // the previous stage is fully consumed
      for (int i = threadIdx.x; i < Kin * len; i += blockDim.x) {
        const int k = i / len, tt = i - k * len;
        T v;
        if (k < nR)
          v = rf_n[k * nT + t0 + tt];
        else if (k < nR + 3)
          v = gr_n[(k - nR) * nT + t0 + tt];
        else
          v = t_n[t0 + tt];
        wf[k * stage + tt] = v;
      }
      __syncthreads();
      const T* w_gr = wf + nR * stage;
      for (int tt = len - 1; tt >= 0; --tt) {
        const T gx = w_gr[tt], gy = w_gr[stage + tt],
                gz = w_gr[2 * stage + tt];
        T ex = 0, ey = 0, ez = 0, dbx = 0, dby = 0, dbz = 0, tv = 0;
        if (active) {
          // the field, as rfgr_fwd builds it
          ex = lx;
          ey = ly;
          ez = lz;
          if (has_vel) {  // moved locations: loc + vel·t
            tv = wf[(nR + 3) * stage + tt];
            ex = lx + tv * vx;
            ey = ly + tv * vy;
            ez = lz + tv * vz;
          }
          T bz = gx * ex + gy * ey + gz * ez;
          if (has_dfg) bz = bz + d;
          T bx, by;
          if (has_b1) {
            bx = 0;
            by = 0;
            if constexpr (kRegB1) {
#pragma unroll
              for (int c = 0; c < MAXC; ++c)
                if (c < nC) {
                  const T rx = wf[c * stage + tt];
                  const T ry = wf[(nC + c) * stage + tt];
                  bx = bx + (b1x[c] * rx - b1y[c] * ry);
                  by = by + (b1x[c] * ry + b1y[c] * rx);
                }
            } else {
              for (int c = 0; c < nC; ++c) {
                const T rx = wf[c * stage + tt];
                const T ry = wf[(nC + c) * stage + tt];
                const T qx = b1_s[c * nS], qy = b1_s[(nC + c) * nS];
                bx = bx + (qx * rx - qy * ry);
                by = by + (qx * ry + qy * rx);
              }
            }
          } else {
            T rx = wf[tt], ry = wf[nC * stage + tt];
            for (int c = 1; c < nC; ++c) {
              rx = rx + wf[c * stage + tt];
              ry = ry + wf[(nC + c) * stage + tt];
            }
            bx = gg * rx;
            by = gg * ry;
          }
          rot_relax_bwd(mx, my, mz, hx, hy, hz, bx, by, bz, relax, E2, E1,
                        e1, iE2, iE1, dbx, dby, dbz);
          // per-spin field gradients
          alx = alx + dbz * gx;
          aly = aly + dbz * gy;
          alz = alz + dbz * gz;
          if (has_dfg) adf = adf + dbz;
          if (has_b1) {
            if constexpr (kRegB1) {
#pragma unroll
              for (int c = 0; c < MAXC; ++c)
                if (c < nC) {
                  const T rx = wf[c * stage + tt];
                  const T ry = wf[(nC + c) * stage + tt];
                  ab1x[c] = ab1x[c] + dbx * rx + dby * ry;
                  ab1y[c] = ab1y[c] + dby * rx - dbx * ry;
                }
            } else {
              for (int c = 0; c < nC; ++c) {
                const T rx = wf[c * stage + tt];
                const T ry = wf[(nC + c) * stage + tt];
                T* ox = db1_s + c * nS;
                T* oy = db1_s + (nC + c) * nS;
                *ox = *ox + dbx * rx + dby * ry;
                *oy = *oy + dby * rx - dbx * ry;
              }
            }
          }
          if (has_vel) {
            avx = avx + dbz * (gx * tv);
            avy = avy + dbz * (gy * tv);
            avz = avz + dbz * (gz * tv);
          }
        }
        // this step's waveform-gradient rows, summed over the warp
        T* wp = wpart + (warp * stage + tt) * Kw;
        T v = warp_sum(dbz * ex);
        if (lane == 0) wp[0] = v;
        v = warp_sum(dbz * ey);
        if (lane == 0) wp[1] = v;
        v = warp_sum(dbz * ez);
        if (lane == 0) wp[2] = v;
        if (has_b1) {
          if constexpr (kRegB1) {
#pragma unroll
            for (int c = 0; c < MAXC; ++c)
              if (c < nC) {
                v = warp_sum(b1x[c] * dbx + b1y[c] * dby);
                if (lane == 0) wp[3 + c] = v;
                v = warp_sum(b1x[c] * dby - b1y[c] * dbx);
                if (lane == 0) wp[3 + nC + c] = v;
              }
          } else {
            for (int c = 0; c < nC; ++c) {  // inactive lanes add 0
              const T qx = active ? b1_s[c * nS] : T(0);
              const T qy = active ? b1_s[(nC + c) * nS] : T(0);
              v = warp_sum(qx * dbx + qy * dby);
              if (lane == 0) wp[3 + c] = v;
              v = warp_sum(qx * dby - qy * dbx);
              if (lane == 0) wp[3 + nC + c] = v;
            }
          }
        } else {
          v = warp_sum(gg * dbx);
          if (lane == 0) wp[3] = v;
          v = warp_sum(gg * dby);
          if (lane == 0) wp[4] = v;
        }
      }
      __syncthreads();
      // the block's sum over its warps: one partial row per step
      for (int i = threadIdx.x; i < len * Kw; i += blockDim.x) {
        const int tt = i / Kw, k = i - tt * Kw;
        T v = 0;
        for (int w = 0; w < kWarps; ++w)
          v = v + wpart[(w * stage + tt) * Kw + k];
        dwf_b[(t0 + tt) * Kw + k] = v;
      }
    }
  }

  if (!active) return;
  dmi[p3] = hx;
  dmi[p3 + nS] = hy;
  dmi[p3 + 2 * nS] = hz;
  dloc[p3] = alx;
  dloc[p3 + nS] = aly;
  dloc[p3 + 2 * nS] = alz;
  if (has_dfg) ddfg[p1] = adf;
  if constexpr (kRegB1) {
    if (has_b1) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < nC) {
          db1_s[c * nS] = ab1x[c];
          db1_s[(nC + c) * nS] = ab1y[c];
        }
    }
  }
  if (has_vel) {
    dvel[p3] = avx;
    dvel[p3 + nS] = avy;
    dvel[p3 + 2 * nS] = avz;
  }
}

template <typename T, int MAXC>
int launch_rfgr_bwd_c(const void* const* in, void* const* out, int64_t N,
                      int64_t nS, int64_t nT, int64_t nC, int64_t tc,
                      bool has_b1, bool has_vel, void* stream) {
  const int Kin = (int)(2 * nC + 3 + (has_vel ? 1 : 0));
  const int Kw = (int)(3 + (has_b1 ? 2 * nC : 2));
  // shared memory per staged step: the waveforms and the warps' row sums
  // (for C ≤ 8 at most 44 KB for kStageBwd steps; more coils stage fewer)
  const size_t per_step = ((size_t)Kin + (size_t)kWarps * Kw) * sizeof(T);
  cudaError_t err = cudaSuccess;
  int stage = kStageBwd;
  if constexpr (MAXC == 0) {
    int dev = 0, smem_max = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const size_t fit = (size_t)smem_max / per_step;
    if (fit < 1) return (int)cudaErrorInvalidValue;
    if (fit < (size_t)kStageBwd) stage = (int)fit;
  }
  const size_t smem = per_step * stage;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rfgr_bwd_kernel<T, MAXC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((nS + kThreads - 1) / kThreads), (unsigned)N);
  rfgr_bwd_kernel<T, MAXC><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const T*)in[5], (const T*)in[6], (const T*)in[7],
      (const T*)in[8], (const T*)in[9], (const T*)in[10], (const T*)in[11],
      (T*)out[0], (T*)out[1], (T*)out[2], (T*)out[3], (T*)out[4],
      (T*)out[5], nS, nT, (int)nC, tc, stage);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rfgr_bwd(const void* const* in, void* const* out, int64_t N,
                     int64_t nS, int64_t nT, int64_t nC, int64_t tc,
                     void* stream) {
  const bool has_b1 = in[6] != nullptr, has_vel = in[10] != nullptr;
  if (N <= 0 || nS <= 0 || nT <= 0 || nC <= 0 || tc <= 0 || nT % tc != 0 ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  // MAXC only sizes the B1 register arrays: without B1 any C takes 1
  const int64_t c = has_b1 ? nC : 1;
  if (c <= 1)
    return launch_rfgr_bwd_c<T, 1>(in, out, N, nS, nT, nC, tc, has_b1,
                                   has_vel, stream);
  if (c <= 2)
    return launch_rfgr_bwd_c<T, 2>(in, out, N, nS, nT, nC, tc, has_b1,
                                   has_vel, stream);
  if (c <= 4)
    return launch_rfgr_bwd_c<T, 4>(in, out, N, nS, nT, nC, tc, has_b1,
                                   has_vel, stream);
  if (c <= 8)
    return launch_rfgr_bwd_c<T, 8>(in, out, N, nS, nT, nC, tc, has_b1,
                                   has_vel, stream);
  return launch_rfgr_bwd_c<T, 0>(in, out, N, nS, nT, nC, tc, has_b1,
                                 has_vel, stream);
}

}  // namespace mrphy

// Inputs (chk, g, rf2, gr2, loc, dfg, b1, E, e1_1, g2pd, vel, tarr) and
// outputs (dmi, dwf, dloc, ddfg, db1, dvel); optional ones are NULL when
// absent. Returns the cudaError_t of the launch (0 = success).
#define MRPHY_RFGR_BWD_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* chk, const void* g, const void* rf2,      \
                      const void* gr2, const void* loc, const void* dfg,    \
                      const void* b1, const void* E, const void* e1_1,      \
                      const void* g2pd, const void* vel, const void* tarr,  \
                      void* dmi, void* dwf, void* dloc, void* ddfg,         \
                      void* db1, void* dvel, int64_t N, int64_t nS,         \
                      int64_t nT, int64_t nC, int64_t tc, void* stream) {   \
    const void* in[12] = {chk, g,    rf2,  gr2, loc, dfg,                   \
                          b1,  E,    e1_1, g2pd, vel, tarr};                \
    void* out[6] = {dmi, dwf, dloc, ddfg, db1, dvel};                       \
    return mrphy::launch_rfgr_bwd<T>(in, out, N, nS, nT, nC, tc, stream);   \
  }

MRPHY_RFGR_BWD_ENTRY(mrphy_rfgr_bwd_f32, float)
MRPHY_RFGR_BWD_ENTRY(mrphy_rfgr_bwd_f64, double)
