// sig_adj: the conjugate-phase back-projection of the k-space signal
// operator on Hopper (sm_90a).
//
// Replaces the TPU kernel `_sig_adj_kernel` (launched by
// `signal_adj_planes`, mrphy_tpu/ops/signal_pallas.py:414). For every spin
// m and every signal row r (re/im of each coil):
//   XR[r, m] = Σ_t C[m, t]·s2[r, t],   XS[r, m] = Σ_t S[m, t]·s2[r, t]
// with the factors C, S of sig_common.cuh. The caller combines them with
// the receive maps into the adjoint magnetization.
//
// The tensor-core kernel of sig_mma.cuh with K = samples and N = spins:
// float32 as split-TF32 mma.sync in three passes, float64 as FP64
// mma.sync. What bounds it: the factors on the FP32 (FP64) pipe; the coil
// sum runs on the tensor cores beside them (the TPU kernel's product on
// its matrix unit at Precision.HIGHEST). Where the spins alone make too
// few blocks to fill the card (bench_recon's 16,384 make 64), the samples
// are split over gridDim.y (nsplit, from the wrapper) into partial rows
// (nsplit, N, 2nC, nM) that the wrapper sums in a fixed order.
#include "sig_mma.cuh"

// Inputs (s2, pos, df, it2, k), the partial outputs XR, XS (nsplit, N,
// 2nC, nM), the batch strides of pos, df, it2 and k (0 = broadcast), N,
// nM, nT, nC, nsplit, dt. df and it2 are NULL when absent. Returns the
// cudaError_t of the launch.
#define MRPHY_SIG_ADJ_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* s2, const void* pos, const void* df,      \
                      const void* it2, const void* k, void* XR, void* XS,   \
                      int64_t pos_bs, int64_t df_bs, int64_t it2_bs,        \
                      int64_t k_bs, int64_t N, int64_t nM, int64_t nT,      \
                      int64_t nC, int64_t nsplit, double dt, void* stream) { \
    const void* in[5] = {s2, pos, df, it2, k};                              \
    const int64_t bs[4] = {pos_bs, df_bs, it2_bs, k_bs};                    \
    return mrphy_sig::mma::launch<T, false>(in, XR, XS, bs, N, nM, nT, nC,  \
                                            nsplit, dt, stream);            \
  }

MRPHY_SIG_ADJ_ENTRY(mrphy_sig_adj_f32, float)
MRPHY_SIG_ADJ_ENTRY(mrphy_sig_adj_f64, double)

// The splits of the sum over samples that fill a card of `sms` SMs.
extern "C" int mrphy_sig_adj_splits(int64_t N, int64_t nM, int64_t nT,
                                    int64_t nC, int64_t sms) {
  return (int)mrphy_sig::mma::splits<false>(N, nM, nT, nC, sms);
}
