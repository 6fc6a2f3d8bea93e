// mc_bwd: the two-phase chunk adjoint of mc_fwd on Hopper (sm_90a).
//
// Replaces the TPU kernel `_mc_bwd_kernel` (launched by `mc_bwd_planes`,
// mrphy_tpu/ops/mc_pallas.py). It does NOT invert steps, as rfgr_bwd does:
// an MT bound pool (T2b ~10 µs at a dwell of 200 µs) makes the transverse
// mix X ~1e-9, which destroys information, and its inverse overflows
// within one chunk. Instead, for every voxel, per chunk of tc steps
// visited newest first:
//   phase 1 restarts from mc_fwd's chunk-start state chk[j] and re-runs
//     the chunk's steps (mc_step.cuh, the forward's very arithmetic),
//     storing the state before every step in `states`;
//   phase 2 walks the stored states backwards: the mix transposed gives
//     the cotangents at the two rotations' outputs, `rot_adj`
//     (bloch_step.cuh) turns each into the cotangent at the rotation's
//     input and ∂L/∂b for its pool (pool b's field has ẑ·sb added), and
//     the kernel accumulates in registers
//       dX += (ha⊥·a1⊥, ha⊥·b1⊥, hb⊥·a1⊥, hb⊥·b1⊥),
//       dZ += (haz·a1z, haz·b1z, hbz·a1z, hbz·b1z, haz, hbz),
//       dsb += ∂L/∂b_z of pool b, dloc += dbz·gr_t, ddfg += dbz,
//       db1_c += (dbx·rf_xc + dby·rf_yc, dby·rf_xc − dbx·rf_yc),
//     with db = ∂L/∂b of both pools, and contributes to the per-step
//     waveform gradient rows as rfgr_bwd does (3 + 2C rows with B1, 5
//     without: Σ dbz·loc_k, then Σ b1·db or Σ γ2πdt·db).
// After chunk j the cotangent of chk[j] is added to the carried one, so a
// loss on any chunk boundary gets its gradient; the last entry of chk is
// the final state and its cotangent starts the walk.
//
// Where the per-step states live: a wrapper-allocated scratch `states`
// (N, tc, 6, nS) in device memory, written and read by voxel, so each
// warp's accesses are coalesced. TPU VMEM has no counterpart here: one
// chunk of states is 6·tc values a voxel (6 KB in float32 at tc = 256),
// far beyond registers and shared memory for a block of voxels. The other
// simple choice, a per-thread local-memory array sized by TC_MAX, is the
// same device memory, reserved for the resident threads only (~1.6 GB
// in float32 on the H100 against 3.1 GB for 512k voxels here); it was
// not taken because its size is fixed at compile time and its traffic
// goes through L1 in a pattern the kernel does not control. The scratch
// costs 2·6·sizeof(T) bytes of traffic per voxel-step (50 GB at 512k
// voxels × 2000 steps in float32), against ~4× mc_fwd's arithmetic.
//
// Rows: each warp reduces its 32 voxels by shuffles at every step, lane 0
// parks the sums in shared memory, and after a stage of steps the block
// adds its 8 warps' sums and writes one partial row per block and step to
// dwf (N, nBlocks, nT, Kw); the wrapper sums the blocks in a fixed order.
// No atomics. Threads past the ragged edge add zeros and take part in
// every shuffle and barrier.
//
// What bounds it on the H100: arithmetic, as mc_fwd (phase 1 is one
// mc_fwd step, phase 2 two rotation adjoints, the accumulators and the
// row shuffles), with the state traffic above behind it.
//
// B1 of C ≤ 8 coils lives in registers (McVoxel, MAXC 1/2/4/8), with
// the db1 accumulators; more coils (MAXC = 0) read B1 from device memory
// every step and accumulate db1 in place in its output, staging fewer
// steps where the rows of many coils would not fit in shared memory.
// Built, like mc_fwd, without FMA contraction in the plain version's order
// of operations (kernels/mc.py `mc_bwd_torch`): the per-voxel outputs
// reproduce it; the rows differ only by the order of the sum over voxels.
#include "mc_step.cuh"

namespace mrphy {

constexpr int kStageBwd = 32;           // most waveform steps per pass
constexpr int kWarps = kThreads / 32;   // warps per block

template <typename T, int MAXC>
__global__ void __launch_bounds__(kThreads)
mc_bwd_kernel(const T* __restrict__ chk, const T* __restrict__ g,
              const T* __restrict__ rf2, const T* __restrict__ gr2,
              const T* __restrict__ loc, const T* __restrict__ dfg,
              const T* __restrict__ b1, const T* __restrict__ g2pd,
              const T* __restrict__ sb, const T* __restrict__ X,
              const T* __restrict__ Z, T* __restrict__ states,
              T* __restrict__ dmi, T* __restrict__ dwf,
              T* __restrict__ dloc, T* __restrict__ ddfg,
              T* __restrict__ db1, T* __restrict__ dsb, T* __restrict__ dX,
              T* __restrict__ dZ, int64_t nS, int64_t nT, int nC,
              int64_t tc, int stage) {
  constexpr bool kRegB1 = MAXC > 0;
  constexpr int kRegC = kRegB1 ? MAXC : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool has_dfg = dfg != nullptr, has_b1 = b1 != nullptr;
  const int nR = 2 * nC;
  const int Kw = 3 + (has_b1 ? nR : 2);  // gradient rows
  T* wf = reinterpret_cast<T*>(smem_raw);  // (nR + 3, stage)
  T* wpart = wf + (nR + 3) * stage;        // (kWarps, stage, Kw)

  const int64_t n = blockIdx.y;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < nS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* rf_n = rf2 + n * nR * nT;
  const T* gr_n = gr2 + n * 3 * nT;
  const int64_t ntc = nT / tc;
  const int64_t o_chk = n * (ntc + 1) * 6 * nS + s;  // state j, row k at
                                                     // [(j * 6 + k) * nS]
  T* st = states + n * tc * 6 * nS + s;              // step i, row k at
                                                     // [(i * 6 + k) * nS]
  T* dwf_b = dwf + ((int64_t)n * gridDim.x + blockIdx.x) * nT * Kw;
  T* db1_s = has_b1 ? db1 + n * nR * nS + s : nullptr;

  McVoxel<T, MAXC> v;
  T h[6] = {0, 0, 0, 0, 0, 0};
  if (active) {
    v.load(loc, dfg, b1, g2pd, sb, X, Z, n, s, nS, nC);
    for (int k = 0; k < 6; ++k) h[k] = g[o_chk + (ntc * 6 + k) * nS];
    if (!kRegB1 && has_b1)
      for (int r = 0; r < nR; ++r) db1_s[r * nS] = 0;
  }
  T al[3] = {0, 0, 0}, aX[4] = {0, 0, 0, 0}, aZ[6] = {0, 0, 0, 0, 0, 0};
  T asb = 0, adf = 0;
  T ab1x[kRegC], ab1y[kRegC];
#pragma unroll
  for (int c = 0; c < kRegC; ++c) {
    ab1x[c] = 0;
    ab1y[c] = 0;
  }

  for (int64_t j = ntc - 1; j >= 0; --j) {
    const int64_t t_beg = j * tc, t_end = (j + 1) * tc;
    // ---- phase 1: the forward from the chunk's start, every state ----
    T m[6] = {0, 0, 0, 0, 0, 0};
    if (active)
      for (int k = 0; k < 6; ++k) m[k] = chk[o_chk + (j * 6 + k) * nS];
    for (int64_t t0 = t_beg; t0 < t_end; t0 += stage) {
      const int len = (int)(t_end - t0 < stage ? t_end - t0 : stage);
      __syncthreads();  // the previous stage is fully consumed
      stage_waveforms(wf, stage, rf_n, gr_n, nR, nT, t0, len);
      __syncthreads();
      if (!active) continue;
      for (int tt = 0; tt < len; ++tt) {
        T* o = st + (t0 - t_beg + tt) * 6 * nS;
        for (int k = 0; k < 6; ++k) o[k * nS] = m[k];
        T bx, by, bz;
        v.field(wf, stage, tt, bx, by, bz);
        v.step(m, bx, by, bz);
      }
    }
    // ---- phase 2: the cotangent, backwards through the stored states ----
    for (int64_t t1 = t_end; t1 > t_beg; t1 -= stage) {
      const int64_t t0 = t1 - stage > t_beg ? t1 - stage : t_beg;
      const int len = (int)(t1 - t0);
      __syncthreads();
      stage_waveforms(wf, stage, rf_n, gr_n, nR, nT, t0, len);
      __syncthreads();
      const T* w_gr = wf + nR * stage;
      for (int tt = len - 1; tt >= 0; --tt) {
        T dbx = 0, dby = 0, dbz = 0;
        if (active) {
          const T* o = st + (t0 - t_beg + tt) * 6 * nS;
          T a[3] = {o[0], o[nS], o[2 * nS]};
          T q[3] = {o[3 * nS], o[4 * nS], o[5 * nS]};
          T fx, fy, fz;
          v.field(wf, stage, tt, fx, fy, fz);
          // the mix transposed: cotangents at the two rotation outputs
          T ha[3] = {v.X00 * h[0] + v.X10 * h[3], v.X00 * h[1] + v.X10 * h[4],
                     v.Z00 * h[2] + v.Z10 * h[5]};
          T hb[3] = {v.X01 * h[0] + v.X11 * h[3], v.X01 * h[1] + v.X11 * h[4],
                     v.Z01 * h[2] + v.Z11 * h[5]};
          T dax, day, daz, dqx, dqy, dqz;
          rot_adj(a[0], a[1], a[2], ha[0], ha[1], ha[2], fx, fy, fz, dax, day,
                  daz);
          rot_adj(q[0], q[1], q[2], hb[0], hb[1], hb[2], fx, fy, fz + v.sb,
                  dqx, dqy, dqz);
          // the propagator planes' cotangents (a, q now the rotated states)
          aX[0] = aX[0] + h[0] * a[0] + h[1] * a[1];
          aX[1] = aX[1] + h[0] * q[0] + h[1] * q[1];
          aX[2] = aX[2] + h[3] * a[0] + h[4] * a[1];
          aX[3] = aX[3] + h[3] * q[0] + h[4] * q[1];
          aZ[0] = aZ[0] + h[2] * a[2];
          aZ[1] = aZ[1] + h[2] * q[2];
          aZ[2] = aZ[2] + h[5] * a[2];
          aZ[3] = aZ[3] + h[5] * q[2];
          aZ[4] = aZ[4] + h[2];
          aZ[5] = aZ[5] + h[5];
          dbx = dax + dqx;
          dby = day + dqy;
          dbz = daz + dqz;
          asb = asb + dqz;
          al[0] = al[0] + dbz * w_gr[tt];
          al[1] = al[1] + dbz * w_gr[stage + tt];
          al[2] = al[2] + dbz * w_gr[2 * stage + tt];
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
          for (int k = 0; k < 3; ++k) {
            h[k] = ha[k];
            h[3 + k] = hb[k];
          }
        }
        // this step's waveform-gradient rows, summed over the warp
        T* wp = wpart + (warp * stage + tt) * Kw;
        T val = warp_sum(dbz * v.lx);
        if (lane == 0) wp[0] = val;
        val = warp_sum(dbz * v.ly);
        if (lane == 0) wp[1] = val;
        val = warp_sum(dbz * v.lz);
        if (lane == 0) wp[2] = val;
        if (has_b1) {
          if constexpr (kRegB1) {
#pragma unroll
            for (int c = 0; c < MAXC; ++c)
              if (c < nC) {
                val = warp_sum(v.b1x[c] * dbx + v.b1y[c] * dby);
                if (lane == 0) wp[3 + c] = val;
                val = warp_sum(v.b1x[c] * dby - v.b1y[c] * dbx);
                if (lane == 0) wp[3 + nC + c] = val;
              }
          } else {
            for (int c = 0; c < nC; ++c) {  // inactive lanes add 0
              const T qx = active ? v.b1_s[c * nS] : T(0);
              const T qy = active ? v.b1_s[(nC + c) * nS] : T(0);
              val = warp_sum(qx * dbx + qy * dby);
              if (lane == 0) wp[3 + c] = val;
              val = warp_sum(qx * dby - qy * dbx);
              if (lane == 0) wp[3 + nC + c] = val;
            }
          }
        } else {
          val = warp_sum(v.g * dbx);
          if (lane == 0) wp[3] = val;
          val = warp_sum(v.g * dby);
          if (lane == 0) wp[4] = val;
        }
      }
      __syncthreads();
      // the block's sum over its warps: one partial row per step
      for (int i = threadIdx.x; i < len * Kw; i += blockDim.x) {
        const int tt = i / Kw, k = i - tt * Kw;
        T val = 0;
        for (int w = 0; w < kWarps; ++w)
          val = val + wpart[(w * stage + tt) * Kw + k];
        dwf_b[(t0 + tt) * Kw + k] = val;
      }
    }
    if (active)  // the cotangent of the chunk's start state
      for (int k = 0; k < 6; ++k)
        h[k] = h[k] + g[o_chk + (j * 6 + k) * nS];
  }

  if (!active) return;
  for (int k = 0; k < 6; ++k) dmi[(n * 6 + k) * nS + s] = h[k];
  for (int k = 0; k < 3; ++k) dloc[(n * 3 + k) * nS + s] = al[k];
  for (int k = 0; k < 4; ++k) dX[(n * 4 + k) * nS + s] = aX[k];
  for (int k = 0; k < 6; ++k) dZ[(n * 6 + k) * nS + s] = aZ[k];
  dsb[n * nS + s] = asb;
  if (has_dfg) ddfg[n * nS + s] = adf;
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
}

template <typename T, int MAXC>
int launch_mc_bwd_c(const void* const* in, void* const* out, int64_t N,
                    int64_t nS, int64_t nT, int64_t nC, int64_t tc,
                    void* stream) {
  const bool has_b1 = in[6] != nullptr;
  const int Kw = (int)(3 + (has_b1 ? 2 * nC : 2));
  // shared memory per staged step: the waveforms and the warps' row sums
  // (for C ≤ 8 at most 44 KB for kStageBwd steps; more coils stage fewer)
  const size_t per_step = ((size_t)(2 * nC + 3) + (size_t)kWarps * Kw) *
                          sizeof(T);
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
    err = cudaFuncSetAttribute(mc_bwd_kernel<T, MAXC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((nS + kThreads - 1) / kThreads), (unsigned)N);
  mc_bwd_kernel<T, MAXC><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const T*)in[5], (const T*)in[6], (const T*)in[7],
      (const T*)in[8], (const T*)in[9], (const T*)in[10], (T*)out[0],
      (T*)out[1], (T*)out[2], (T*)out[3], (T*)out[4], (T*)out[5],
      (T*)out[6], (T*)out[7], (T*)out[8], nS, nT, (int)nC, tc, stage);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mc_bwd(const void* const* in, void* const* out, int64_t N,
                  int64_t nS, int64_t nT, int64_t nC, int64_t tc,
                  void* stream) {
  if (N <= 0 || nS <= 0 || nT <= 0 || nC <= 0 || tc <= 0 || nT % tc != 0 ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch_coils(in[6] != nullptr, nC, [&](auto maxc) {
    return launch_mc_bwd_c<T, decltype(maxc)::value>(in, out, N, nS, nT, nC,
                                                     tc, stream);
  });
}

}  // namespace mrphy

// Inputs (chk, g, rf2, gr2, loc, dfg, b1, g2pd, sb, X, Z), the scratch
// `states` (N, tc, 6, nS) and the outputs (dmi, dwf, dloc, ddfg, db1, dsb,
// dX, dZ); dfg/ddfg and b1/db1 are NULL when absent. Returns the
// cudaError_t of the launch (0 = success).
#define MRPHY_MC_BWD_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* chk, const void* g, const void* rf2,       \
                      const void* gr2, const void* loc, const void* dfg,     \
                      const void* b1, const void* g2pd, const void* sb,      \
                      const void* X, const void* Z, void* states, void* dmi, \
                      void* dwf, void* dloc, void* ddfg, void* db1,          \
                      void* dsb, void* dX, void* dZ, int64_t N, int64_t nS,  \
                      int64_t nT, int64_t nC, int64_t tc, void* stream) {    \
    const void* in[11] = {chk, g, rf2, gr2, loc, dfg, b1, g2pd, sb, X, Z};  \
    void* out[9] = {states, dmi, dwf, dloc, ddfg, db1, dsb, dX, dZ};        \
    return mrphy::launch_mc_bwd<T>(in, out, N, nS, nT, nC, tc, stream);     \
  }

MRPHY_MC_BWD_ENTRY(mrphy_mc_bwd_f32, float)
MRPHY_MC_BWD_ENTRY(mrphy_mc_bwd_f64, double)
