// The k-space signal kernels K7 sig_fwd and K9 sig_adj on Hopper's tensor
// cores (sm_90a): one design for both, in float32 (split TF32, below) and
// float64 (FP64 mma.sync, sig_dmma_kernel).
//
// Both are a product of data rows with a factor matrix formed on the fly,
// C, S = E·cos ψ, E·sin ψ of every spin m and sample t (sig_common.cuh):
//   K7:  U = w2 · C,   V = w2 · S    (rows × samples, summed over spins)
//   K9:  XR = s2 · Cᵀ, XS = s2 · Sᵀ  (rows × spins, summed over samples)
// In mma terms the rows are M, the sum runs over K and the outputs' other
// axis is N: for K7, K = spins and N = samples; for K9, K = samples and
// N = spins. A = the data rows (w2 or s2), B = the factors.
//
// What bounds it: the factors' instructions. Per spin-sample the fast
// path issues ~50: the phase (7, unfused so that φ is the plain version's
// bit for bit), the half-cycle reduction and its sign (4), sin and cos
// (~18), the decay (3), the split of C and S (10) and 3/8 of an HMMA
// (bench_signal's 8 coils: 24 m16n8k8 per warp and k-step of 8·8·NT
// spin-samples). The tensor cores' instructions issue from the same warps
// and do not hide behind the FP32 work: the two extra passes cost ~20% of
// the time. The coil sum, which the first port ran as 2R FMAs per
// spin-sample on CUDA cores (forming every phase again for each group of 8
// coils), is tensor-core work here.
//
// Design:
// - Factors go straight into mma.sync B fragments
//   (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32). In a warp,
//   thread (gid = lane / 4, tig = lane % 4) forms exactly the elements it
//   holds in B: k = tig and k = tig + 4 of column n = gid. Each spin-sample
//   factor is formed once, by one thread, and never leaves its registers.
// - Register blocking: a warp owns NT n8 tiles (NT·8 samples or spins), so
//   a thread keeps its NT columns' values in registers (K7: kx, ky, kz,
//   t_t of a sample; K9: x, y, z, Δf, 1/T2* of a spin) and each k-step's
//   two k-side values, read from shared memory, serve all NT tiles.
// - The A operand, the data rows, is staged per pass of KT k-values (128,
//   64 at RB 4) in shared memory, split once per element into TF32 hi and
//   lo parts, in fragment order: lane l's four A registers of a (k-step,
//   row tile) are one 16-byte word, so a warp's fragment load is 512
//   contiguous bytes (no bank conflicts).
// - All rows against each factor fragment: a block holds RB m16 row tiles
//   (RB = 1, 2 or 4 by the coil count: 16·RB rows, 8·RB coils) as
//   accumulators, and every row tile is multiplied with each fragment. The
//   phase is formed once per spin-sample for up to 32 coils. Past that the
//   rows are cut into blocks of 64 (gridDim.z), each forming the factors
//   again: 64 coils form them twice. (RB·NT = 4 keeps the accumulators and
//   their sums at 64 registers a thread; 16 warps an SM. NT = 2 at 24
//   warps an SM was no faster.)
// - Split TF32, three passes, FP32 accumulators: x = hi + lo with hi =
//   cvt.rna.tf32(x), lo = cvt.rna.tf32(x − hi) (|x − hi − lo| ≤ 2⁻²²|x|;
//   the rounding by integer operations, `tf32`); each product is Alo·Bhi +
//   Ahi·Blo + Ahi·Bhi, small terms first. The tensor cores' own
//   accumulation does not round to nearest (one chain over a split's
//   spins put bench_signal's outputs 1.4–2.4e-4 off), so a pass of KT
//   k-values accumulates from zero and is then added to FP32 sums in
//   registers: no accumulator chain is longer than 3·KT/8 products.
// - The sign without a 64-bit conversion: y = 2φ + 1.5·2²³ rounds 2φ to
//   the nearest integer, ties to even, exactly as rint while |2φ| < 2²²;
//   j = y − 1.5·2²³ and (−1)^j is the low bit of y's pattern. Each pass
//   checks the bound of |φ| over its k-values and the block's columns
//   (Σ max|x_i|·max|k_i| + max|Δf|·max|t_t|, block-uniform) and takes the
//   exact route (rint, the 64-bit parity) where it could break that limit.
//   φ, j and r stay bit for bit the plain version's (-fmad=false; the
//   explicit FMAs here are exact).
// - No atomics: K7 splits the spins over gridDim.y (the wrapper sums the
//   splits' partial rows in a fixed order); K9 splits the samples likewise
//   where its spins alone do not fill the card. `splits` picks their
//   number, which the wrapper asks for (mrphy_sig_{fwd,adj}_splits) to
//   size the partial rows; this header alone holds the tile geometry. Two
//   launches give the same bits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sig_common.cuh"

namespace mrphy_sig {
namespace mma {

constexpr int kWarps = 8;                 // warps per block
constexpr int kBlock = kWarps * 32;       // threads per block
constexpr int kBlocksPerSM = 2;           // 16 warps an SM
constexpr float kMagic = 12582912.0f;     // 1.5·2²³
constexpr float kFastLimit = 0x1.ffcp20f;  // |φ| bound under 2²¹ (1 − 2⁻¹¹)
constexpr float kLog2e = 1.44269504f;

// For RB row tiles: the n8 tiles a warp owns, the k-values a pass stages
// (the staged rows take 8 KB·RB per 64 k-values: 128 while that stays
// within 32 KB; 128 against 64 was 4–5% faster at bench_signal) and the
// m16n8k8 k-steps of a pass.
constexpr int col_tiles(int rb) { return 4 / rb; }
constexpr int pass_k(int rb) { return rb == 4 ? 64 : 128; }

template <int RB>
struct Tiles {
  static constexpr int NT = col_tiles(RB);
  static constexpr int KT = pass_k(RB);
  static constexpr int Steps = KT / 8;
};

// The m16 row tiles a block holds for nC coils (2nC rows): 1, 2 or 4; past
// 64 rows the rows take several blocks of 64.
__host__ inline int row_tiles(int64_t nC) {
  const int64_t tiles = (2 * nC + 15) / 16;
  return tiles <= 1 ? 1 : tiles <= 2 ? 2 : 4;
}

// The splits of the sum over K (the spins of K7, the samples of K9): as
// many as two waves of blocks over the card's sms fill, each at least one
// pass of k-values; 1 where the columns and row blocks alone fill them.
template <bool kFwd>
__host__ int64_t splits(int64_t N, int64_t nM, int64_t nT, int64_t nC,
                        int64_t sms) {
  const int rb = row_tiles(nC);
  const int64_t nN = kFwd ? nT : nM, nK = kFwd ? nM : nT;
  const int64_t per = (int64_t)kWarps * 8 * col_tiles(rb);
  const int64_t base = (nN + per - 1) / per * N *
                       ((2 * nC + 16 * rb - 1) / (16 * rb));
  const int64_t most = 2 * kBlocksPerSM * sms / base;
  const int64_t passes = (nK + pass_k(rb) - 1) / pass_k(rb);
  const int64_t n = passes < most ? passes : most;
  return n > 1 ? n : 1;
}

// cvt.rna.tf32.f32 by integer operations: round to nearest, ties away from
// zero, to 10 mantissa bits (finite x; ptxas expands the cvt into a longer
// sequence that also handles NaN and infinity)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32, to 2⁻²²|x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// sin(πa), cos(πa) for |a| ≤ 1/2: a = q/2 + t with q = rint(2a) ∈ {−1, 0,
// 1} (the magic number again) and |t| ≤ 1/4, then minimax polynomials of
// sin(πt)/t and cos(πt) in t² (Lawson-weighted least squares in float64,
// coefficients rounded to float32; evaluated with FMAs they are within
// 8.3e-8 of sin and 5.8e-8 of cos on |t| ≤ 1/4, and tests/
// test_torch_signal_split.py holds both at 8.5e-8 over |a| ≤ 1/2), and the
// quarter turn for q = ±1. The
// library's sincospif reduces its argument again by rint and a conversion
// to int, which the reduced a does not need.
__device__ __forceinline__ void sincospi_reduced(float a, float& s, float& c) {
  const float q = __fmaf_rn(a, 2.0f, kMagic) - kMagic;
  const float t = __fmaf_rn(q, -0.5f, a);  // exact
  const float u = t * t;
  float ps = __fmaf_rn(-0x1.2d9bb6p-1f, u, 0x1.465ec6p+1f);
  ps = __fmaf_rn(ps, u, -0x1.4abbbap+2f);
  ps = __fmaf_rn(ps, u, 0x1.921fb6p+1f);
  const float s0 = ps * t;
  float pc = __fmaf_rn(0x1.d9c364p-3f, u, -0x1.55c57cp+0f);
  pc = __fmaf_rn(pc, u, 0x1.03c1dcp+2f);
  pc = __fmaf_rn(pc, u, -0x1.3bd3ccp+2f);
  const float c0 = __fmaf_rn(pc, u, 1.0f);
  const bool quarter = q != 0.0f;  // sin(πt ± π/2) = ±cos(πt), …
  s = quarter ? c0 : s0;
  c = quarter ? s0 : c0;
  if (q < 0.0f) s = -s;
  if (q > 0.0f) c = -c;
}

// The factors of phase φ (cycles) with decay exponent e2 = −t_t·(1/T2*)·
// log2 e (the wrappers' 1/T2* arrive here times −log2 e): the
// arithmetic of sig_common.cuh `factors` with the sign from the magic
// number (kExact: rint and the 64-bit parity, for any |φ|), sin/cos by
// sincospi_reduced, and the decay E = 2^e2 by the hardware's ex2
// (relative error ~2⁻²² beside the exponent's rounding: at most ~2e-8 of 1
// in absolute terms, where expf's software steps cost 10% of the kernel's
// time).
template <bool kExact, bool kRelax>
__device__ __forceinline__ void factor(float phi, float e2, float& C,
                                       float& S) {
  float a;  // −2r = j − 2φ, exact
  uint32_t sgn;
  if constexpr (kExact) {
    const float j = rintf(phi + phi);
    a = __fmaf_rn(phi, -2.0f, j);
    sgn = (uint32_t)(static_cast<long long>(j) & 1) << 31;
  } else {
    const float y = __fmaf_rn(phi, 2.0f, kMagic);  // j + 1.5·2²³
    a = __fmaf_rn(phi, -2.0f, y - kMagic);
    sgn = __float_as_uint(y) << 31;
  }
  float s, c;
  sincospi_reduced(a, s, c);
  if constexpr (kRelax) {  // E = ±2^e2, the sign in the decay
    float E;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(E) : "f"(e2));
    E = __uint_as_float(__float_as_uint(E) ^ sgn);
    C = E * c;
    S = E * s;
  } else {
    C = __uint_as_float(__float_as_uint(c) ^ sgn);
    S = __uint_as_float(__float_as_uint(s) ^ sgn);
  }
}

__device__ __forceinline__ float4 abs_max(float4 a, float4 b) {
  return make_float4(fmaxf(fabsf(a.x), fabsf(b.x)),
                     fmaxf(fabsf(a.y), fabsf(b.y)),
                     fmaxf(fabsf(a.z), fabsf(b.z)),
                     fmaxf(fabsf(a.w), fabsf(b.w)));
}

__device__ __forceinline__ float4 warp_abs_max(float4 v) {
  v = abs_max(v, v);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float4 w = make_float4(__shfl_xor_sync(0xffffffffu, v.x, o),
                                 __shfl_xor_sync(0xffffffffu, v.y, o),
                                 __shfl_xor_sync(0xffffffffu, v.z, o),
                                 __shfl_xor_sync(0xffffffffu, v.w, o));
    v = abs_max(v, w);
  }
  return v;
}

// One staged pass: KS k-steps of every row tile against the factors
// of the warp's NT column tiles, into acc[row tile][column tile][C/S].
// sK holds the k-side values: a spin's (x, y, z, Δf) and sI its −(1/T2*)·
// log2 e (kFwd), or a sample's (kx, ky, kz, t_t); ni the same of the
// thread's spins (K9).
template <bool kFwd, bool kDf, bool kRelax, bool kExact, int RB, int NT,
          int KS>
__device__ __forceinline__ void pass(
    const uint4 (&sA)[2][KS][RB][32], const float4* sK, const float* sI,
    const float4 (&nv)[NT], const float (&ni)[NT],
    float (&acc)[RB][NT][2][4], int lane) {
  const int tig = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < KS; ++ks) {
    const float4 k0 = sK[ks * 8 + tig], k1 = sK[ks * 8 + tig + 4];
    float i0 = 0.0f, i1 = 0.0f;
    if constexpr (kFwd && kRelax) {
      i0 = sI[ks * 8 + tig];
      i1 = sI[ks * 8 + tig + 4];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float C0, S0, C1, S1;
      if constexpr (kFwd) {  // k: spins (x, y, z, Δf); n: a sample
        factor<kExact, kRelax>(
            phase(k0.x, k0.y, k0.z, k0.w, kDf, nv[j].x, nv[j].y, nv[j].z,
                  nv[j].w),
            nv[j].w * i0, C0, S0);
        factor<kExact, kRelax>(
            phase(k1.x, k1.y, k1.z, k1.w, kDf, nv[j].x, nv[j].y, nv[j].z,
                  nv[j].w),
            nv[j].w * i1, C1, S1);
      } else {  // k: samples (kx, ky, kz, t_t); n: a spin
        factor<kExact, kRelax>(
            phase(nv[j].x, nv[j].y, nv[j].z, nv[j].w, kDf, k0.x, k0.y, k0.z,
                  k0.w),
            k0.w * ni[j], C0, S0);
        factor<kExact, kRelax>(
            phase(nv[j].x, nv[j].y, nv[j].z, nv[j].w, kDf, k1.x, k1.y, k1.z,
                  k1.w),
            k1.w * ni[j], C1, S1);
      }
      uint32_t ch0, cl0, ch1, cl1, sh0, sl0, sh1, sl1;
      split(C0, ch0, cl0);
      split(C1, ch1, cl1);
      split(S0, sh0, sl0);
      split(S1, sh1, sl1);
#pragma unroll
      for (int rt = 0; rt < RB; ++rt) {
        const uint4 ah = sA[0][ks][rt][lane], al = sA[1][ks][rt][lane];
        mma_tf32(acc[rt][j][0], al, ch0, ch1);
        mma_tf32(acc[rt][j][0], ah, cl0, cl1);
        mma_tf32(acc[rt][j][0], ah, ch0, ch1);
        mma_tf32(acc[rt][j][1], al, sh0, sh1);
        mma_tf32(acc[rt][j][1], ah, sl0, sl1);
        mma_tf32(acc[rt][j][1], ah, sh0, sh1);
      }
    }
  }
}

// Grid (⌈nN / (8·NT·kWarps)⌉, nsplit, N·row blocks). A (N, 2nC, nK): w2
// (kFwd) or s2; outC/outS (nsplit, N, 2nC, nN): U/V (kFwd) or XR/XS.
template <bool kFwd, bool kDf, bool kRelax, int RB>
__global__ void __launch_bounds__(kBlock, kBlocksPerSM)
sig_mma_kernel(const float* __restrict__ A, const float* __restrict__ pos,
               int64_t pos_bs, const float* __restrict__ df, int64_t df_bs,
               const float* __restrict__ it2, int64_t it2_bs,
               const float* __restrict__ k, int64_t k_bs,
               float* __restrict__ outC, float* __restrict__ outS, int64_t N,
               int64_t nM, int64_t nT, int64_t nC, float dt) {
  constexpr int NT = Tiles<RB>::NT, KT = Tiles<RB>::KT;
  constexpr int RR = 16 * RB;  // rows a block holds
  __shared__ uint4 sA[2][Tiles<RB>::Steps][RB][32];  // hi, lo A fragments
  __shared__ float4 sK[KT];
  __shared__ float sI[kFwd && kRelax ? KT : 1];
  __shared__ float4 sNmax[kWarps];
  __shared__ float4 sKmax[KT / 32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t nR = 2 * nC;
  const int64_t blocks = (nR + RR - 1) / RR;
  const int64_t b = blockIdx.z / blocks;
  const int64_t row0 = (blockIdx.z % blocks) * RR;
  const int64_t nK = kFwd ? nM : nT, nN = kFwd ? nT : nM;
  const float* A_b = A + b * nR * nK;
  const float* p_b = pos + b * pos_bs;
  const float* d_b = kDf ? df + b * df_bs : nullptr;
  const float* i_b = kRelax ? it2 + b * it2_bs : nullptr;
  const float* k_b = k + b * k_bs;
  const int64_t n0 = ((int64_t)blockIdx.x * kWarps + warp) * 8 * NT;

  // the thread's columns: column gid of each of its NT tiles (zeros past
  // the ragged edge: finite factors, never stored)
  float4 nv[NT];
  float ni[NT];
  float4 nmax = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int64_t i = n0 + 8 * j + gid;
    const bool in = i < nN;
    ni[j] = 0.0f;
    if constexpr (kFwd) {
      nv[j] = make_float4(in ? k_b[i] : 0.0f, in ? k_b[nT + i] : 0.0f,
                          in ? k_b[2 * nT + i] : 0.0f,
                          in ? float(i + 1) * dt : 0.0f);
    } else {
      nv[j] = make_float4(in ? p_b[i] : 0.0f, in ? p_b[nM + i] : 0.0f,
                          in ? p_b[2 * nM + i] : 0.0f,
                          (kDf && in) ? d_b[i] : 0.0f);
      if constexpr (kRelax) ni[j] = in ? i_b[i] * -kLog2e : 0.0f;
    }
    nmax = abs_max(nmax, nv[j]);
  }
  nmax = warp_abs_max(nmax);
  if (lane == 0) sNmax[warp] = nmax;

  float acc[RB][NT][2][4], sum[RB][NT][2][4];
#pragma unroll
  for (int rt = 0; rt < RB; ++rt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rt][j][h][q] = sum[rt][j][h][q] = 0.0f;

  // this split's passes: [tile0, tile1)
  const int64_t tiles = (nK + KT - 1) / KT;
  const int64_t per = (tiles + gridDim.y - 1) / gridDim.y;
  const int64_t tile0 = blockIdx.y * per;
  const int64_t tile1 = tile0 + per < tiles ? tile0 + per : tiles;
  for (int64_t tile = tile0; tile < tile1; ++tile) {
    const int64_t k0 = tile * KT;
    __syncthreads();  // the previous pass is fully consumed
    // the rows' tile, split once, in fragment order: element (r, c) is
    // register q of lane (r % 8)·4 + c % 4 in (k-step c / 8, tile r / 16)
    for (int e = threadIdx.x; e < RR * KT; e += kBlock) {
      const int r = e / KT, c = e % KT;
      const int64_t row = row0 + r, kk = k0 + c;
      const float v = (row < nR && kk < nK) ? A_b[row * nK + kk] : 0.0f;
      uint32_t hi, lo;
      split(v, hi, lo);
      const int rr = r & 15, cc = c & 7;
      const int fl = (rr & 7) * 4 + (cc & 3), q = (rr >> 3) + 2 * (cc >> 2);
      reinterpret_cast<uint32_t*>(&sA[0][c >> 3][r >> 4][fl])[q] = hi;
      reinterpret_cast<uint32_t*>(&sA[1][c >> 3][r >> 4][fl])[q] = lo;
    }
    // the k-side values and their largest magnitudes
    if (threadIdx.x < KT) {
      const int c = threadIdx.x;
      const int64_t kk = k0 + c;
      const bool in = kk < nK;
      float4 v;
      if constexpr (kFwd) {
        v = make_float4(in ? p_b[kk] : 0.0f, in ? p_b[nM + kk] : 0.0f,
                        in ? p_b[2 * nM + kk] : 0.0f,
                        (kDf && in) ? d_b[kk] : 0.0f);
        if constexpr (kRelax) sI[c] = in ? i_b[kk] * -kLog2e : 0.0f;
      } else {
        v = make_float4(in ? k_b[kk] : 0.0f, in ? k_b[nT + kk] : 0.0f,
                        in ? k_b[2 * nT + kk] : 0.0f,
                        in ? float(kk + 1) * dt : 0.0f);
      }
      sK[c] = v;
      v = warp_abs_max(v);
      if (lane == 0) sKmax[warp] = v;
    }
    __syncthreads();
    float4 km = sKmax[0], nm = sNmax[0];
#pragma unroll
    for (int w = 1; w < KT / 32; ++w) km = abs_max(km, sKmax[w]);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) nm = abs_max(nm, sNmax[w]);
    const float bound = ((km.x * nm.x + km.y * nm.y) + km.z * nm.z) +
                        km.w * nm.w;
    if (bound < kFastLimit)  // block-uniform
      pass<kFwd, kDf, kRelax, false, RB, NT>(sA, sK, sI, nv, ni, acc, lane);
    else
      pass<kFwd, kDf, kRelax, true, RB, NT>(sA, sK, sI, nv, ni, acc, lane);
    // fold the pass into the sums, rounding to nearest
#pragma unroll
    for (int rt = 0; rt < RB; ++rt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sum[rt][j][h][q] = sum[rt][j][h][q] + acc[rt][j][h][q];
            acc[rt][j][h][q] = 0.0f;
          }
  }

  // accumulator q of a tile: row gid + 8·(q / 2), column 2·tig + q % 2
  const int64_t base = ((int64_t)blockIdx.y * N + b) * nR * nN;
#pragma unroll
  for (int rt = 0; rt < RB; ++rt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t row = row0 + rt * 16 + gid + 8 * (q >> 1);
        const int64_t col = n0 + 8 * j + 2 * tig + (q & 1);
        if (row < nR && col < nN) {
          outC[base + row * nN + col] = sum[rt][j][0][q];
          outS[base + row * nN + col] = sum[rt][j][1][q];
        }
      }
}

// float64: the same product on the FP64 tensor cores,
// mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64, in one pass (double
// products and sums, rounded to nearest), with the factors of
// sig_common.cuh `factors` (the exact sign, the library's sincospi and
// exp). The geometry is float32's: a block holds RB m16 row tiles as 2·RB
// m8 tiles, a warp NT n8 column tiles, a pass KT k-values, and thread
// (gid, tig) forms B's element (k = tig, n = gid) of each column tile, so
// each factor once per spin-sample. Fragments (PTX ISA, m8n8k4 .f64): A's
// a0 is (row gid, k tig), B's b0 (k tig, column gid), D's d0, d1 (row gid,
// columns 2·tig and 2·tig + 1): an m16 tile's accumulators q = 0..3 are
// those of its two m8 tiles, laid out as float32's. What bounds it: the
// factors' double instructions (the library's sincospi and exp) on the
// FP64 pipe. It replaced CUDA-core kernels (2R DFMAs a spin-sample, the
// phase formed again for each group of 8 coils) by measurement (PERF.md
// §6).
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// Grid, A and outputs as sig_mma_kernel.
template <bool kFwd, bool kDf, bool kRelax, int RB>
__global__ void __launch_bounds__(kBlock, kBlocksPerSM)
sig_dmma_kernel(const double* __restrict__ A,
                const double* __restrict__ pos, int64_t pos_bs,
                const double* __restrict__ df, int64_t df_bs,
                const double* __restrict__ it2, int64_t it2_bs,
                const double* __restrict__ k, int64_t k_bs,
                double* __restrict__ outC, double* __restrict__ outS,
                int64_t N, int64_t nM, int64_t nT, int64_t nC, double dt) {
  constexpr int NT = Tiles<RB>::NT, KT = Tiles<RB>::KT;
  constexpr int RR = 16 * RB;
  __shared__ double sA[KT / 4][2 * RB][32];  // A fragments by k-step of 4
  // k side: a spin's x, y, z, Δf, 1/T2* (kFwd) or a sample's kx, ky, kz, t_t
  __shared__ double sK[5][KT];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t nR = 2 * nC;
  const int64_t blocks = (nR + RR - 1) / RR;
  const int64_t b = blockIdx.z / blocks;
  const int64_t row0 = (blockIdx.z % blocks) * RR;
  const int64_t nK = kFwd ? nM : nT, nN = kFwd ? nT : nM;
  const double* A_b = A + b * nR * nK;
  const double* p_b = pos + b * pos_bs;
  const double* d_b = kDf ? df + b * df_bs : nullptr;
  const double* i_b = kRelax ? it2 + b * it2_bs : nullptr;
  const double* k_b = k + b * k_bs;
  const int64_t n0 = ((int64_t)blockIdx.x * kWarps + warp) * 8 * NT;

  // the thread's columns, as the k side (zeros past the ragged edge)
  double nv[NT][5];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int64_t i = n0 + 8 * j + gid;
    const bool in = i < nN;
    if constexpr (kFwd) {
      nv[j][0] = in ? k_b[i] : 0.0;
      nv[j][1] = in ? k_b[nT + i] : 0.0;
      nv[j][2] = in ? k_b[2 * nT + i] : 0.0;
      nv[j][3] = in ? double(i + 1) * dt : 0.0;
      nv[j][4] = 0.0;
    } else {
      nv[j][0] = in ? p_b[i] : 0.0;
      nv[j][1] = in ? p_b[nM + i] : 0.0;
      nv[j][2] = in ? p_b[2 * nM + i] : 0.0;
      nv[j][3] = (kDf && in) ? d_b[i] : 0.0;
      nv[j][4] = (kRelax && in) ? i_b[i] : 0.0;
    }
  }

  double acc[RB][NT][2][4];
#pragma unroll
  for (int rt = 0; rt < RB; ++rt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rt][j][h][q] = 0.0;

  const int64_t tiles = (nK + KT - 1) / KT;
  const int64_t per = (tiles + gridDim.y - 1) / gridDim.y;
  const int64_t tile0 = blockIdx.y * per;
  const int64_t tile1 = tile0 + per < tiles ? tile0 + per : tiles;
  for (int64_t tile = tile0; tile < tile1; ++tile) {
    const int64_t k0 = tile * KT;
    __syncthreads();  // the previous pass is fully consumed
    // element (r, c) is a0 of lane (r % 8)·4 + c % 4 in (k-step c / 4, m8
    // tile r / 8)
    for (int e = threadIdx.x; e < RR * KT; e += kBlock) {
      const int r = e / KT, c = e % KT;
      const int64_t row = row0 + r, kk = k0 + c;
      sA[c >> 2][r >> 3][(r & 7) * 4 + (c & 3)] =
          (row < nR && kk < nK) ? A_b[row * nK + kk] : 0.0;
    }
    if (threadIdx.x < KT) {
      const int c = threadIdx.x;
      const int64_t kk = k0 + c;
      const bool in = kk < nK;
      if constexpr (kFwd) {
        sK[0][c] = in ? p_b[kk] : 0.0;
        sK[1][c] = in ? p_b[nM + kk] : 0.0;
        sK[2][c] = in ? p_b[2 * nM + kk] : 0.0;
        sK[3][c] = (kDf && in) ? d_b[kk] : 0.0;
        sK[4][c] = (kRelax && in) ? i_b[kk] : 0.0;
      } else {
        sK[0][c] = in ? k_b[kk] : 0.0;
        sK[1][c] = in ? k_b[nT + kk] : 0.0;
        sK[2][c] = in ? k_b[2 * nT + kk] : 0.0;
        sK[3][c] = in ? double(kk + 1) * dt : 0.0;
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int ks = 0; ks < KT / 4; ++ks) {
      const int c = ks * 4 + tig;
      const double k0v = sK[0][c], k1v = sK[1][c], k2v = sK[2][c],
                   k3v = sK[3][c];
      const double k4v = kFwd && kRelax ? sK[4][c] : 0.0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        double C, S;
        if constexpr (kFwd)  // k: a spin; n: a sample
          factors(phase(k0v, k1v, k2v, k3v, kDf, nv[j][0], nv[j][1],
                        nv[j][2], nv[j][3]),
                  nv[j][3], k4v, kRelax, C, S);
        else  // k: a sample; n: a spin
          factors(phase(nv[j][0], nv[j][1], nv[j][2], nv[j][3], kDf, k0v,
                        k1v, k2v, k3v),
                  k3v, nv[j][4], kRelax, C, S);
#pragma unroll
        for (int mt = 0; mt < 2 * RB; ++mt) {
          const double a = sA[ks][mt][lane];
          double(&dc)[4] = acc[mt >> 1][j][0];
          double(&ds)[4] = acc[mt >> 1][j][1];
          const int q = 2 * (mt & 1);
          mma_f64(dc[q], dc[q + 1], a, C);
          mma_f64(ds[q], ds[q + 1], a, S);
        }
      }
    }
  }

  const int64_t base = ((int64_t)blockIdx.y * N + b) * nR * nN;
#pragma unroll
  for (int rt = 0; rt < RB; ++rt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t row = row0 + rt * 16 + gid + 8 * (q >> 1);
        const int64_t col = n0 + 8 * j + 2 * tig + (q & 1);
        if (row < nR && col < nN) {
          outC[base + row * nN + col] = acc[rt][j][0][q];
          outS[base + row * nN + col] = acc[rt][j][1][q];
        }
      }
}

// Calls f(IntC<RB>, IntC<has Δf>, IntC<relax>).
template <typename F>
__host__ int dispatch_cfg(int64_t rb, bool has_df, bool relax, F&& f) {
  auto flags = [&](auto r) {
    if (has_df)
      return relax ? f(r, IntC<1>{}, IntC<1>{}) : f(r, IntC<1>{}, IntC<0>{});
    return relax ? f(r, IntC<0>{}, IntC<1>{}) : f(r, IntC<0>{}, IntC<0>{});
  };
  if (rb == 1) return flags(IntC<1>{});
  if (rb == 2) return flags(IntC<2>{});
  return flags(IntC<4>{});
}

// Inputs (A, pos, df, it2, k), outputs outC/outS (nsplit, N, 2nC, nN), the
// batch strides of pos, df, it2 and k, N, nM, nT, nC, nsplit (any ≥ 1;
// `splits` gives the one that fills the card), dt; T float (split TF32) or
// double (FP64 mma). Returns the cudaError_t of the launch.
template <typename T, bool kFwd>
int launch(const void* const* in, void* outC, void* outS, const int64_t* bs,
           int64_t N, int64_t nM, int64_t nT, int64_t nC, int64_t nsplit,
           double dt, void* stream) {
  if (N <= 0 || nM <= 0 || nT <= 0 || nC <= 0 || nsplit <= 0 ||
      nsplit > 65535)
    return cudaErrorInvalidValue;
  return dispatch_cfg(row_tiles(nC), in[2] != nullptr, in[3] != nullptr,
                      [&](auto r, auto d, auto x) {
    constexpr int RB = decltype(r)::value;
    constexpr bool kDf = decltype(d)::value != 0;
    constexpr bool kRelax = decltype(x)::value != 0;
    constexpr int NT = Tiles<RB>::NT;
    const int64_t blocks = (2 * nC + 16 * RB - 1) / (16 * RB);
    const int64_t nz = N * blocks, nN = kFwd ? nT : nM;
    const int64_t per = (int64_t)kWarps * 8 * NT;
    if (nz > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((nN + per - 1) / per), (unsigned)nsplit,
                    (unsigned)nz);
    void (*kernel)(const T*, const T*, int64_t, const T*, int64_t,
                   const T*, int64_t, const T*, int64_t, T*, T*, int64_t,
                   int64_t, int64_t, int64_t, T);
    if constexpr (sizeof(T) == 4)
      kernel = sig_mma_kernel<kFwd, kDf, kRelax, RB>;
    else
      kernel = sig_dmma_kernel<kFwd, kDf, kRelax, RB>;
    kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        (const T*)in[0], (const T*)in[1], bs[0], (const T*)in[2], bs[1],
        (const T*)in[3], bs[2], (const T*)in[4], bs[3], (T*)outC, (T*)outS,
        N, nM, nT, nC, (T)dt);
    return (int)cudaGetLastError();
  });
}

}  // namespace mma
}  // namespace mrphy_sig
