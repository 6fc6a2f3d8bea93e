// mc_fwd: the fused two-pool Bloch–McConnell forward on Hopper (sm_90a).
//
// Replaces the TPU kernel `_mc_fwd_kernel` (launched by `mc_fwd_planes`,
// mrphy_tpu/ops/mc_pallas.py). For every voxel and all nT steps it
// assembles B-effective from rf × multi-coil b1 (or the coil-summed rf),
// gr·loc and Δf, rotates pool a about it and pool b about it plus ẑ·sb
// (Rodrigues, two sincos), and mixes the pools with the exact 2×2
// exchange/relaxation propagators (mc_step.cuh). The state at the start of
// every chunk of tc steps is written to chk (N, ntc + 1, 6, nS), the final
// state last: the restart points of the two-phase adjoint mc_bwd.
//
// What bounds it on the H100: arithmetic. Per voxel-step it does two
// rotations (two sincos with full range reduction, two rsqrt, ~130
// multiplies and adds without FMA contraction) and the 12-multiply mix,
// about twice rfgr_fwd's step; inside the time loop it touches no device
// memory (B1 of up to 8 coils in registers, more coils read per step as
// rfgr_fwd does). Device-memory traffic is the 22 per-voxel inputs and
// 6·(ntc + 1) outputs, O(nS·ntc).
//
// Design: one thread per voxel, grid (ceil(nS/256), N), both pools' six
// values and the voxel's constants in registers. The waveforms of batch n,
// rf2 (N, 2C, nT) and gr2 (N, 3, nT), are staged into shared memory kStage
// steps at a time by the whole block and broadcast from there. Threads
// past the ragged edge take part in the staging and the barriers but
// compute and store nothing. Built without FMA contraction, in the plain
// version's order of operations (kernels/mc.py `mc_fwd_torch`): the two
// agree bit for bit. Templated on the scalar type (float is the production
// instance; double gives a tight check against JAX in float64) and on
// MAXC, the B1 register width (mc_step.cuh `dispatch_coils`).
#include "mc_step.cuh"

namespace mrphy {

constexpr int kStage = 64;  // waveform steps staged per shared-memory pass

template <typename T, int MAXC>
__global__ void __launch_bounds__(kThreads)
mc_fwd_kernel(const T* __restrict__ mi6, const T* __restrict__ rf2,
              const T* __restrict__ gr2, const T* __restrict__ loc,
              const T* __restrict__ dfg, const T* __restrict__ b1,
              const T* __restrict__ g2pd, const T* __restrict__ sb,
              const T* __restrict__ X, const T* __restrict__ Z,
              T* __restrict__ chk, int64_t nS, int64_t nT, int nC,
              int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wf = reinterpret_cast<T*>(smem_raw);  // (2C + 3, kStage)

  const int64_t n = blockIdx.y;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < nS;
  const int nR = 2 * nC;
  const T* rf_n = rf2 + n * nR * nT;
  const T* gr_n = gr2 + n * 3 * nT;
  const int64_t ntc = nT / tc;

  McVoxel<T, MAXC> v;
  T m[6] = {0, 0, 0, 0, 0, 0};
  if (active) {
    v.load(loc, dfg, b1, g2pd, sb, X, Z, n, s, nS, nC);
    for (int k = 0; k < 6; ++k) m[k] = mi6[(n * 6 + k) * nS + s];
  }
  T* chk_s = chk + n * (ntc + 1) * 6 * nS + s;  // state j at [j * 6 * nS]
  for (int64_t j = 0; j < ntc; ++j) {
    if (active)
      for (int k = 0; k < 6; ++k) chk_s[(j * 6 + k) * nS] = m[k];
    const int64_t t_end = (j + 1) * tc;
    for (int64_t t0 = j * tc; t0 < t_end; t0 += kStage) {
      const int len = (int)(t_end - t0 < kStage ? t_end - t0 : kStage);
      __syncthreads();  // the previous stage is fully consumed
      stage_waveforms(wf, kStage, rf_n, gr_n, nR, nT, t0, len);
      __syncthreads();
      if (!active) continue;
      for (int tt = 0; tt < len; ++tt) {
        T bx, by, bz;
        v.field(wf, kStage, tt, bx, by, bz);
        v.step(m, bx, by, bz);
      }
    }
  }
  if (active)
    for (int k = 0; k < 6; ++k) chk_s[(ntc * 6 + k) * nS] = m[k];
}

template <typename T, int MAXC>
int launch_mc_fwd_c(const void* const* in, void* chk, int64_t N, int64_t nS,
                    int64_t nT, int64_t nC, int64_t tc, void* stream) {
  const size_t smem = (size_t)(2 * nC + 3) * kStage * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mc_fwd_kernel<T, MAXC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((nS + kThreads - 1) / kThreads), (unsigned)N);
  mc_fwd_kernel<T, MAXC><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const T*)in[5], (const T*)in[6], (const T*)in[7],
      (const T*)in[8], (const T*)in[9], (T*)chk, nS, nT, (int)nC, tc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mc_fwd(const void* const* in, void* chk, int64_t N, int64_t nS,
                  int64_t nT, int64_t nC, int64_t tc, void* stream) {
  if (N <= 0 || nS <= 0 || nT <= 0 || nC <= 0 || tc <= 0 || nT % tc != 0 ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch_coils(in[5] != nullptr, nC, [&](auto maxc) {
    return launch_mc_fwd_c<T, decltype(maxc)::value>(in, chk, N, nS, nT, nC,
                                                     tc, stream);
  });
}

}  // namespace mrphy

// Inputs (mi6, rf2, gr2, loc, dfg, b1, g2pd, sb, X, Z) and the output chk;
// dfg and b1 are NULL when absent. Returns the cudaError_t of the launch
// (0 = success).
#define MRPHY_MC_FWD_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* mi6, const void* rf2, const void* gr2,     \
                      const void* loc, const void* dfg, const void* b1,      \
                      const void* g2pd, const void* sb, const void* X,       \
                      const void* Z, void* chk, int64_t N, int64_t nS,       \
                      int64_t nT, int64_t nC, int64_t tc, void* stream) {    \
    const void* in[10] = {mi6, rf2, gr2, loc, dfg, b1, g2pd, sb, X, Z};     \
    return mrphy::launch_mc_fwd<T>(in, chk, N, nS, nT, nC, tc, stream);     \
  }

MRPHY_MC_FWD_ENTRY(mrphy_mc_fwd_f32, float)
MRPHY_MC_FWD_ENTRY(mrphy_mc_fwd_f64, double)
