// rfgr_fwd: the fused RF/gradient Bloch forward on Hopper (sm_90a).
//
// Replaces the TPU kernel `_rfgr_fwd_kernel` (launched by
// `rfgr_fwd_planes`, mrphy_tpu/ops/pallas_kernels.py). For every spin and
// all nT steps it assembles B-effective from rf × multi-coil b1 (or the
// coil-summed rf), gr·(loc + vel·t) and Δf, rotates the magnetization
// (Rodrigues) and relaxes it; the state at the end of every chunk of tc
// steps is written to chk (N, ntc, 3, nS) — the final state is chk[:, -1],
// the others are the restart points of the reconstruction adjoint.
//
// What bounds it on the H100: arithmetic. Per spin-step it does one
// sincos (full range reduction, the rotation angle reaches several
// radians), one rsqrt and ~70 multiplies and adds (no FMA contraction,
// see bloch_step.cuh), and it touches no device memory inside
// the time loop except the per-spin b1 row (2C values, L1-resident) — all
// other per-spin state (m, loc, vel, Δf, E1/E2/e1_1, γ2πdt) lives in
// registers for the whole loop. Device-memory traffic is O(nS·(ntc + 1))
// in total, independent of nT within a chunk.
//
// Design: one thread per spin, grid (ceil(nS/256), N). The waveforms of
// batch n — rf2 (N, 2C, nT) with rows [x coils…, y coils…], gr2 (N, 3, nT)
// and, with flow, the per-step times tarr (N, nT) — are staged into shared
// memory kStage steps at a time by the whole block (cooperative coalesced
// load, __syncthreads, then the steps), so each waveform value is read
// from device memory once per block and broadcast from shared memory.
// Threads past the ragged edge (s >= nS) take part in the staging and
// the barriers but compute and store nothing.
//
// Templated on the scalar type: float is the production instance, double
// gives a tight check against the plain PyTorch version on the card.
#include "bloch_step.cuh"

namespace mrphy {

constexpr int kStage = 64;  // waveform steps staged per shared-memory pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
rfgr_fwd_kernel(const T* __restrict__ mi, const T* __restrict__ rf2,
                const T* __restrict__ gr2, const T* __restrict__ loc,
                const T* __restrict__ dfg, const T* __restrict__ b1,
                const T* __restrict__ E, const T* __restrict__ e1_1,
                const T* __restrict__ g2pd, const T* __restrict__ vel,
                const T* __restrict__ tarr, T* __restrict__ chk,
                int64_t nS, int64_t nT, int nC, int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wf = reinterpret_cast<T*>(smem_raw);  // (K, kStage), K = 2C + 3 [+ 1]

  const int64_t n = blockIdx.y;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < nS;
  const bool has_dfg = dfg != nullptr, has_b1 = b1 != nullptr;
  const bool relax = E != nullptr, has_vel = vel != nullptr;
  const int nR = 2 * nC;                  // rf rows
  const int K = nR + 3 + (has_vel ? 1 : 0);

  const T* rf_n = rf2 + n * nR * nT;
  const T* gr_n = gr2 + n * 3 * nT;
  const T* t_n = has_vel ? tarr + n * nT : nullptr;
  const int64_t p1 = n * nS + s;          // (N, nS) planes
  const int64_t p3 = n * 3 * nS + s;      // (N, 3, nS) planes

  T mx = 0, my = 0, mz = 0, lx = 0, ly = 0, lz = 0, vx = 0, vy = 0, vz = 0;
  T d = 0, g = 0, E2 = 1, E1 = 1, e1 = 0;
  const T* b1_s = nullptr;
  if (active) {
    mx = mi[p3];
    my = mi[p3 + nS];
    mz = mi[p3 + 2 * nS];
    lx = loc[p3];
    ly = loc[p3 + nS];
    lz = loc[p3 + 2 * nS];
    if (has_vel) {
      vx = vel[p3];
      vy = vel[p3 + nS];
      vz = vel[p3 + 2 * nS];
    }
    if (has_dfg) d = dfg[p1];
    g = g2pd[p1];
    if (relax) {
      E2 = E[p3];
      E1 = E[p3 + 2 * nS];
      e1 = e1_1[p1];
    }
    if (has_b1) b1_s = b1 + n * nR * nS + s;  // row r at b1_s[r * nS]
  }

  const int64_t ntc = nT / tc;
  for (int64_t j = 0; j < ntc; ++j) {
    const int64_t t_end = (j + 1) * tc;
    for (int64_t t0 = j * tc; t0 < t_end; t0 += kStage) {
      const int len = (int)(t_end - t0 < kStage ? t_end - t0 : kStage);
      __syncthreads();  // the previous stage is fully consumed
      for (int i = threadIdx.x; i < K * len; i += blockDim.x) {
        const int k = i / len, tt = i - k * len;
        T v;
        if (k < nR)
          v = rf_n[k * nT + t0 + tt];
        else if (k < nR + 3)
          v = gr_n[(k - nR) * nT + t0 + tt];
        else
          v = t_n[t0 + tt];
        wf[k * kStage + tt] = v;
      }
      __syncthreads();
      if (!active) continue;
      const T* w_gr = wf + nR * kStage;
      for (int tt = 0; tt < len; ++tt) {
        // the field, in the plain version's order of operations
        T ex = lx, ey = ly, ez = lz;
        if (has_vel) {  // moved locations: loc + vel·t
          const T tv = wf[(nR + 3) * kStage + tt];
          ex = lx + tv * vx;
          ey = ly + tv * vy;
          ez = lz + tv * vz;
        }
        T bz = w_gr[tt] * ex + w_gr[kStage + tt] * ey +
               w_gr[2 * kStage + tt] * ez;
        if (has_dfg) bz = bz + d;
        T bx, by;
        if (has_b1) {
          bx = 0;
          by = 0;
          for (int c = 0; c < nC; ++c) {
            const T b1x = b1_s[c * nS], b1y = b1_s[(nC + c) * nS];
            const T rx = wf[c * kStage + tt], ry = wf[(nC + c) * kStage + tt];
            bx = bx + (b1x * rx - b1y * ry);
            by = by + (b1x * ry + b1y * rx);
          }
        } else {
          T rx = wf[tt], ry = wf[nC * kStage + tt];
          for (int c = 1; c < nC; ++c) {
            rx = rx + wf[c * kStage + tt];
            ry = ry + wf[(nC + c) * kStage + tt];
          }
          bx = g * rx;
          by = g * ry;
        }
        rot_relax(mx, my, mz, bx, by, bz, relax, E2, E1, e1);
      }
    }
    if (active) {
      T* o = chk + (n * ntc + j) * 3 * nS + s;
      o[0] = mx;
      o[nS] = my;
      o[2 * nS] = mz;
    }
  }
}

template <typename T>
int launch_rfgr_fwd(const void* mi, const void* rf2, const void* gr2,
                    const void* loc, const void* dfg, const void* b1,
                    const void* E, const void* e1_1, const void* g2pd,
                    const void* vel, const void* tarr, void* chk, int64_t N,
                    int64_t nS, int64_t nT, int64_t nC, int64_t tc,
                    void* stream) {
  if (N <= 0 || nS <= 0 || nT <= 0 || nC <= 0 || tc <= 0 || nT % tc != 0 ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  const int K = (int)(2 * nC + 3 + (vel ? 1 : 0));
  const size_t smem = (size_t)K * kStage * sizeof(T);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rfgr_fwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((nS + kThreads - 1) / kThreads), (unsigned)N);
  rfgr_fwd_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)mi, (const T*)rf2, (const T*)gr2, (const T*)loc,
      (const T*)dfg, (const T*)b1, (const T*)E, (const T*)e1_1,
      (const T*)g2pd, (const T*)vel, (const T*)tarr, (T*)chk, nS, nT,
      (int)nC, tc);
  return (int)cudaGetLastError();
}

}  // namespace mrphy

// Optional inputs (dfg, b1, E with e1_1, vel with tarr) are NULL when
// absent. Returns the cudaError_t of the launch (0 = success).
extern "C" int mrphy_rfgr_fwd_f32(const void* mi, const void* rf2,
                                  const void* gr2, const void* loc,
                                  const void* dfg, const void* b1,
                                  const void* E, const void* e1_1,
                                  const void* g2pd, const void* vel,
                                  const void* tarr, void* chk, int64_t N,
                                  int64_t nS, int64_t nT, int64_t nC,
                                  int64_t tc, void* stream) {
  return mrphy::launch_rfgr_fwd<float>(mi, rf2, gr2, loc, dfg, b1, E, e1_1,
                                       g2pd, vel, tarr, chk, N, nS, nT, nC,
                                       tc, stream);
}

extern "C" int mrphy_rfgr_fwd_f64(const void* mi, const void* rf2,
                                  const void* gr2, const void* loc,
                                  const void* dfg, const void* b1,
                                  const void* E, const void* e1_1,
                                  const void* g2pd, const void* vel,
                                  const void* tarr, void* chk, int64_t N,
                                  int64_t nS, int64_t nT, int64_t nC,
                                  int64_t tc, void* stream) {
  return mrphy::launch_rfgr_fwd<double>(mi, rf2, gr2, loc, dfg, b1, E, e1_1,
                                        g2pd, vel, tarr, chk, N, nS, nT, nC,
                                        tc, stream);
}
