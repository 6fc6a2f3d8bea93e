// xcpmg_fwd: the two-pool EPG-X CPMG echo train (myelin-water fraction,
// exchange-sensitive T2 mapping) on Hopper (sm_90a), at a fixed echo
// spacing or over an echo-spacing train, with and without chunk
// checkpoints.
//
// Replaces four TPU kernels of mrphy_tpu/ops/epg_pallas.py: `_xcpmg_kernel`
// (launched by `_xcpmg_core`), the echo train of an MWF map, as the entry
// points mrphy_xcpmg_fwd_*; `_xcpmg_fwd_chk_kernel` (launched by
// `_xcpmg_core_fwd`), the same train writing the pre-echo state at the
// start of every chunk of tc echoes for the adjoint xcpmg_bwd, as
// mrphy_xcpmg_fwd_chk_*; and their counterparts over a per-echo spacing
// `_xcpmg_v_kernel` (`_xcpmg_core_v`) and `_xcv_fwd_chk_kernel`
// (`_xcpmg_core_v_fwd`), as mrphy_xcpmg_v_fwd_* and mrphy_xcpmg_v_fwd_chk_*,
// which read the 14 propagator entries of echo t over esp_t/2 from the
// per-echo planes pkt (nE, 14, nA) once, coalesced across atoms, for both
// of its halves. The π/2 excitation about φ_ex is the closed-form
// state it leaves on the equilibrium (per pool F± = (sin φ_ex ∓ i·cos
// φ_ex)·M0p, Z = 0). Per atom and echo: the exact exchange-relaxation over
// esp/2 of every order of both pools (epgx_common.cuh `xrelax`: the complex
// 2×2 propagator on F+, its conjugate on F−, the real 2×2 on Z with the
// affine recovery into Z(0)) and a unit shift, the refocusing mix about +x
// on both pools (cpmg_common.cuh `mix0`), the same half again, and the echo
// Fa+(0) + Fb+(0), not demodulated. Options: per-atom b1 (half-angle trig
// per atom and echo).
//
// What bounds it on the H100: arithmetic. Per atom, order and echo the two
// halves' exchange-relaxations and the two mixes are ~130 multiplies and
// adds without FMA contraction: ~1.4e11 operations at 1,048,576 atoms × 32
// echoes × K 33, ~2.1 ms at the card's float32 peak. Device memory sees the
// per-atom rows once, the echoes (268 MB there) and, for the checkpoints,
// tc-spaced states (at 262,144 atoms, tc 4: 3.3 GB); over an echo-spacing
// train also the planes, 14 values per atom and echo (1.9 GB at 1,048,576
// atoms × 32 echoes, ~0.56 ms at the card's rate).
//
// Design, as xspgr_fwd.cu and cpmg_fwd.cu: one thread per atom walks the
// whole train; its 12·K state values (1,584 B at K 33 in float32) live in
// shared memory, planes strided by the block's threads (32/64/128 a block
// as kernels/epg.py `launch_cfg` chose with 12 planes: 128 resident threads
// an SM at K 33 in float32), both pools' F± planes ring buffers over the
// orders sharing one pair of offsets (the pools shift alike), or in device
// memory where 32 threads' states would not fit (K > 151 in float32). The
// 14 propagator entries over esp/2 sit in registers (over a train, echo
// t's, loaded at its start). Each half is one pass over the orders: the
// first half's relaxes in place, the second mixes and relaxes. The echoes
// are written (nE, nA), atoms fastest (coalesced).
// Built without FMA contraction, in the plain version's order of operations
// (kernels/epgx.py `xcpmg_fwd_torch`, `xcpmg_v_fwd_torch`): the two agree
// bit for bit. Templated on the scalar type, on the checkpoints and on the
// echo-spacing train (VARESP).
#include "cpmg_common.cuh"
#include "epgx_common.cuh"

namespace mrphy {
namespace xcpmg {

using epgx::kPlanes;
using epgx::Prop;
using spgr::Planes;

// pk: (19, nA) per-atom rows [E00r, E00i, E01r, E01i, E10r, E10i, E11r,
// E11i, Z00, Z01, Z10, Z11, ra, rb, cos φ_ex, sin φ_ex, M0a, M0b, b1]; over
// an echo-spacing train (VARESP) the last five rows (5, nA), the entries of
// echo t at pkt + t·14·nA.
template <typename T, bool CHK, bool VARESP>
__global__ void xcpmg_fwd_kernel(const T* __restrict__ coef,
                                 const T* __restrict__ pk,
                                 const T* __restrict__ pkt,
                                 T* __restrict__ er, T* __restrict__ ei,
                                 T* __restrict__ chk, T* __restrict__ gstate,
                                 int64_t nA, int64_t nE, int K, int flags,
                                 int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= nA) return;
  const bool has_b1 = flags & cpmg::kB1;
  const Planes<T> st =
      gstate ? Planes<T>{gstate + a, nA, K}
             : Planes<T>{reinterpret_cast<T*>(smem_raw) + threadIdx.x,
                         (int64_t)blockDim.x, K};
  const Planes<T> sb = epgx::pool_b(st);
  Prop<T> e{};
  if constexpr (!VARESP) e = epgx::load_prop(pk, nA, a);
  const T* pm = VARESP ? pk : pk + 14 * nA;  // [exc, exs, M0a, M0b, b1]
  const T exc = pm[a], exs = pm[nA + a], M0a = pm[2 * nA + a],
          M0b = pm[3 * nA + a], b1 = pm[4 * nA + a];
  for (int p = 0; p < kPlanes; ++p)
    for (int k = 0; k < K; ++k) st(p, k) = T(0);
  // the excitation's state, per pool F+(0) = (exs, −exc)·M0p, F−(0) =
  // (exs, exc)·M0p
  st(0, 0) = exs * M0a;
  st(1, 0) = -exc * M0a;
  st(2, 0) = exs * M0a;
  st(3, 0) = exc * M0a;
  sb(0, 0) = exs * M0b;
  sb(1, 0) = -exc * M0b;
  sb(2, 0) = exs * M0b;
  sb(3, 0) = exc * M0b;
  int op = 0, om = 0;  // the ring offsets of F+ and F− (both pools)
  for (int64_t t = 0; t < nE; ++t) {
    if (CHK && t % tc == 0) {
      // the chunk's start state, orders in logical order
      T* c = chk + (t / tc) * kPlanes * K * nA + a;
      int ip = op, im = om;
      for (int k = 0; k < K; ++k) {
        for (int q = 0; q < 2; ++q) {
          const Planes<T>& s = q ? sb : st;
          T* cq = c + (int64_t)6 * q * K * nA;
          cq[(0 * (int64_t)K + k) * nA] = s(0, ip);
          cq[(1 * (int64_t)K + k) * nA] = s(1, ip);
          cq[(2 * (int64_t)K + k) * nA] = s(2, im);
          cq[(3 * (int64_t)K + k) * nA] = s(3, im);
          cq[(4 * (int64_t)K + k) * nA] = s(4, k);
          cq[(5 * (int64_t)K + k) * nA] = s(5, k);
        }
        ip = spgr::wrap_inc(ip, K);
        im = spgr::wrap_inc(im, K);
      }
    }
    // echo t's propagator over esp_t/2, both halves
    if constexpr (VARESP) e = epgx::load_prop(pkt + t * 14 * nA, nA, a);
    const cpmg::Trig<T> g = cpmg::trig(coef, nE, t, b1, has_b1);
    // the first half: the exchange-relaxation of every order in place,
    // then the unit shift
    int ip = op, im = om;
    for (int k = 0; k < K; ++k) {
      T na[6] = {st(0, ip), st(1, ip), st(2, im), st(3, im), st(4, k),
                 st(5, k)};
      T nb[6] = {sb(0, ip), sb(1, ip), sb(2, im), sb(3, im), sb(4, k),
                 sb(5, k)};
      epgx::xrelax(e, k, na, nb);
      st(0, ip) = na[0];
      st(1, ip) = na[1];
      st(2, im) = na[2];
      st(3, im) = na[3];
      st(4, k) = na[4];
      st(5, k) = na[5];
      sb(0, ip) = nb[0];
      sb(1, ip) = nb[1];
      sb(2, im) = nb[2];
      sb(3, im) = nb[3];
      sb(4, k) = nb[4];
      sb(5, k) = nb[5];
      ip = spgr::wrap_inc(ip, K);
      im = spgr::wrap_inc(im, K);
    }
    epgx::ring_shift2(st, op, om, 1);
    // the refocusing on both pools, the second half's exchange-relaxation,
    // the unit shift
    ip = op;
    im = om;
    for (int k = 0; k < K; ++k) {
      const T xa[6] = {st(0, ip), st(1, ip), st(2, im),
                       st(3, im), st(4, k),  st(5, k)};
      const T xb[6] = {sb(0, ip), sb(1, ip), sb(2, im),
                       sb(3, im), sb(4, k),  sb(5, k)};
      T na[6], nb[6];
      cpmg::mix0(g, xa, na);
      cpmg::mix0(g, xb, nb);
      epgx::xrelax(e, k, na, nb);
      st(0, ip) = na[0];
      st(1, ip) = na[1];
      st(2, im) = na[2];
      st(3, im) = na[3];
      st(4, k) = na[4];
      st(5, k) = na[5];
      sb(0, ip) = nb[0];
      sb(1, ip) = nb[1];
      sb(2, im) = nb[2];
      sb(3, im) = nb[3];
      sb(4, k) = nb[4];
      sb(5, k) = nb[5];
      ip = spgr::wrap_inc(ip, K);
      im = spgr::wrap_inc(im, K);
    }
    epgx::ring_shift2(st, op, om, 1);
    // the echo: the total F+(0)
    er[t * nA + a] = st(0, op) + sb(0, op);
    ei[t * nA + a] = st(1, op) + sb(1, op);
  }
}

template <typename T, bool CHK, bool VARESP>
int launch_xcpmg_fwd(const T* coef, const T* pk, const T* pkt, T* er, T* ei,
                     T* chk, T* gstate, int64_t nA, int64_t nE, int64_t K,
                     int64_t flags, int64_t tc, int64_t threads,
                     void* stream) {
  if (nA <= 0 || nE <= 0 || K < 2 || tc <= 0 || nE % tc != 0 ||
      (flags & ~(int64_t)cpmg::kB1) != 0 ||
      !spgr::valid_threads((int)threads) || (CHK && chk == nullptr) ||
      (VARESP && pkt == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      gstate ? 0 : (size_t)threads * kPlanes * (size_t)K * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xcpmg_fwd_kernel<T, CHK, VARESP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + threads - 1) / threads);
  xcpmg_fwd_kernel<T, CHK, VARESP><<<grid, (unsigned)threads, smem,
                                     (cudaStream_t)stream>>>(
      coef, pk, pkt, er, ei, chk, gstate, nA, nE, (int)K, (int)flags, tc);
  return (int)cudaGetLastError();
}

}  // namespace xcpmg
}  // namespace mrphy

// Inputs (coef (5, nE), pk (19, nA)), the echoes er, ei (nE, nA), the
// checkpoints chk (nE / tc, 12, K, nA) (the _chk entries only), the state
// in device memory gstate (12, K, nA) or NULL to keep it in shared memory;
// sizes, flags (1 b1), tc, threads per block. Returns the cudaError_t of
// the launch (0 = success).
#define MRPHY_XCPMG_FWD_ENTRY(NAME, T, CHK)                                  \
  extern "C" int NAME(const void* coef, const void* pk, void* er, void* ei, \
                      void* chk, void* gstate, int64_t nA, int64_t nE,      \
                      int64_t K, int64_t flags, int64_t tc, int64_t threads, \
                      void* stream) {                                        \
    return mrphy::xcpmg::launch_xcpmg_fwd<T, CHK, false>(                    \
        (const T*)coef, (const T*)pk, nullptr, (T*)er, (T*)ei, (T*)chk,      \
        (T*)gstate, nA, nE, K, flags, tc, threads, stream);                  \
  }

MRPHY_XCPMG_FWD_ENTRY(mrphy_xcpmg_fwd_f32, float, false)
MRPHY_XCPMG_FWD_ENTRY(mrphy_xcpmg_fwd_f64, double, false)
MRPHY_XCPMG_FWD_ENTRY(mrphy_xcpmg_fwd_chk_f32, float, true)
MRPHY_XCPMG_FWD_ENTRY(mrphy_xcpmg_fwd_chk_f64, double, true)

// The echo-spacing train: inputs coef (5, nE), pk (5, nA) = [cos φ_ex,
// sin φ_ex, M0a, M0b, b1] and the planes pkt (nE, 14, nA), each echo's
// propagator over esp_t/2; the outputs as above.
#define MRPHY_XCPMG_V_FWD_ENTRY(NAME, T, CHK)                                \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,    \
                      void* er, void* ei, void* chk, void* gstate,          \
                      int64_t nA, int64_t nE, int64_t K, int64_t flags,     \
                      int64_t tc, int64_t threads, void* stream) {          \
    return mrphy::xcpmg::launch_xcpmg_fwd<T, CHK, true>(                     \
        (const T*)coef, (const T*)pk, (const T*)pkt, (T*)er, (T*)ei,         \
        (T*)chk, (T*)gstate, nA, nE, K, flags, tc, threads, stream);         \
  }

MRPHY_XCPMG_V_FWD_ENTRY(mrphy_xcpmg_v_fwd_f32, float, false)
MRPHY_XCPMG_V_FWD_ENTRY(mrphy_xcpmg_v_fwd_f64, double, false)
MRPHY_XCPMG_V_FWD_ENTRY(mrphy_xcpmg_v_fwd_chk_f32, float, true)
MRPHY_XCPMG_V_FWD_ENTRY(mrphy_xcpmg_v_fwd_chk_f64, double, true)
