// sig_fwd: the forward k-space signal operator on Hopper (sm_90a).
//
// Replaces the TPU kernel `_sig_fwd_kernel` (launched by
// `signal_fwd_planes`, mrphy_tpu/ops/signal_pallas.py:311). For every
// sample t and every row r of the coil-weighted spins w2 (re/im of each
// coil):
//   U[r, t] = Σ_m w2[r, m]·C[m, t],   V[r, t] = Σ_m w2[r, m]·S[m, t]
// with the factors C, S of sig_common.cuh; the caller forms the signal
// s_re = U[:nC] − V[nC:], s_im = V[:nC] + U[nC:].
//
// The tensor-core kernel of sig_mma.cuh with K = spins and N = samples:
// float32 as split-TF32 mma.sync in three passes, float64 as FP64
// mma.sync. What bounds it: the factors on the FP32 (FP64) pipe; the coil
// sum runs on the tensor cores beside them, as the TPU kernel ran the same
// product on its matrix unit at Precision.HIGHEST. The spins are split over
// gridDim.y (nsplit, chosen by the wrapper so that the blocks fill the
// card: 16,384 samples make only 64 blocks); each split writes its partial
// rows Upart/Vpart (nsplit, N, 2nC, nT) and the wrapper sums them in a
// fixed order (no atomics).
#include "sig_mma.cuh"

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
    return mrphy_sig::mma::launch<T, true>(in, Upart, Vpart, bs, N, nM, nT, \
                                           nC, nsplit, dt, stream);         \
  }

MRPHY_SIG_FWD_ENTRY(mrphy_sig_fwd_f32, float)
MRPHY_SIG_FWD_ENTRY(mrphy_sig_fwd_f64, double)

// The splits of the sum over spins that fill a card of `sms` SMs.
extern "C" int mrphy_sig_fwd_splits(int64_t N, int64_t nM, int64_t nT,
                                    int64_t nC, int64_t sms) {
  return (int)mrphy_sig::mma::splits<true>(N, nM, nT, nC, sms);
}
