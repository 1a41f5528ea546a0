// Device functions of the split-DFT float MFCC tail: the window on the even
// and odd frame positions, the nfft/2-point DFT of each half as a product
// with the cos / -sin operator in the form dft_passes selects, twiddle
// recombination, power on bins [0, nfft/2), the banded mel sum with floor
// and log2, and the DCT product with the (S, F, ncep) f32 store.  Shared by
// K5 (float_fused.cu: from raw audio, and from frames) and the split-DFT
// serving step (stream_step.cu: from carry and chunk): each kernel has its
// own ingest, which hands every f32 pre-emphasized sample pair of a tile of
// FT frames to put_pair(); the tail is the same arithmetic in the same
// order for all three, so a streamed int16 frame is a batch frame.
//
// Replaces mfcc_tpu/ops/pallas_mfcc.py:_radix2_core.  What it computes, in
// natural bin order (nh = nfft/2, nh2 = nfft/4, j = 0..nh2):
//   xe[m] = y[2m] * we[m], xo[m] = y[2m+1] * wo[m]       (f32)
//   E_j = sum_m C[j m mod nh] xe[m] (+ i S[j m mod nh] xe[m]), O_j alike,
//     with C = cos(2 pi i/nh)/nfft and S = -sin(2 pi i/nh)/nfft as f32;
//   A_j = E_j + W^j O_j -> bin j, B_j = E_j - W^j O_j -> bin nh - j (j >= 1),
//   bin nh2 = Re(E_nh2)^2 + Re(O_nh2)^2;  all f32, rounded as written.
//
// The DFT product.  dft_passes 3/4 split each operand into two bf16 limbs
// (hi = bf16(v), lo = bf16(v - hi), round to nearest even), as the TPU
// kernel does for its MXU passes: the limb split sets the fast mode's
// error against the float64 oracle, so it is kept.  The limb products
// hi*hi + hi*lo + lo*hi (+ lo*lo) are summed as (hi+lo)(hi+lo) (- lo*lo):
// every product is exact in FP64, and the sums are FP64 FMAs, rounded to
// f32 once.  6 passes is the plain f32 operands' product, exact in FP64.
// The TPU sums in f32; on quiet mel bands of long inputs two f32
// summation orders differ by ~1.5e-3 after log2 (a numpy emulation of this
// loop against torch's sgemm on 8 streams x 4 s), which would make kernel
// and plain version unverifiable against each other, so the sum is FP64
// here and in the plain version.
//
// The operator is circulant in index (row j, column m is entry j*m mod nh),
// so the block keeps the nh-entry cos and -sin tables (as FP64 (s, l)
// operand pairs, 16*nfft bytes with a pad entry per 8) in shared memory
// instead of the nh x nh matrix (256 KB in f32 at nfft 512, more than a
// block's shared memory).  The sin row of j = 0 is identically zero; that
// thread slot computes the cos row of j = nh2 instead.
//
// Layout of the block's dynamic shared memory (FT frames, NS = 2 FT
// signals, signal 2f + h being half h of frame f): NS rows of nh operand
// pairs (double2) and kXPad pad entries, reused after the product for the NS x 2 x nh2 f32 DFT rows,
// the FT x nh power rows and the FT x nfilters log-mel rows; then the two
// tables, the nh2 twiddles (cos, sin) and the mel band limits.
//
// The product runs on the FP64 tensor cores (mma.sync m8n8k4 .f64, the
// double-precision Hopper MMA): the operator rows are the A fragments,
// looked up from the tables per (row, column), the operand pairs of 8
// signals the B fragments, and each warp keeps an 8-row-tile x 8-signal
// block of accumulators (RT x ST tiles of 8 x 8, RT * ST = 8).  Products
// and sums are FP64 as in an FMA loop, at twice the FMA rate and with one
// shared load per 4 columns per fragment; 3 passes issues a second MMA on
// the lo limbs.
//
// What bounds it: the DFT product, ~nh^2 FP64 multiply-adds per signal
// (twice that at 3 passes), 2.6e5 (5.2e5) per frame at nfft 512, against
// ~2e4 for the rest of the tail; the shared loads of the fragments come
// next.  A bf16 tensor-core product of the limbs with f32 accumulation
// would reach the card's bf16 rate, but its f32 sums are the order noise
// that the FP64 sum removes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "fladder_stages.cuh"   // allow_smem

namespace radix2_stages {

constexpr int kThreads = 256;
constexpr int kTilePoints = 4096;   // FT * nfft per block
constexpr int kXPad = 4;            // pad entries per signal row of sm.x

// Frames per block: 16, 8, 4 at nfft 256, 512, 1024.
inline int frames_per_block(int nfft) { return kTilePoints / nfft; }

// Signal tiles of 8 per block (2 FT / 8): 4, 2, 1 at nfft 256, 512, 1024;
// the template argument ST of the kernels.
inline int signal_tiles(int nfft) { return frames_per_block(nfft) / 4; }

// Table entry i at tpad(i): one pad entry per 8 spreads the column reads of
// a warp's j slots over the banks.
__device__ __forceinline__ int tpad(int i) { return i + (i >> 3); }
__host__ __device__ inline int table_entries(int nh) { return nh + (nh >> 3); }

__host__ __device__ inline size_t region_bytes(int FT, int nfft, int nfilters) {
  const size_t nh = nfft / 2;
  const size_t x = sizeof(double2) * 2 * FT * (nh + kXPad);
  const size_t tail = sizeof(float) * (3 * FT * nh + FT * nfilters);
  return x > tail ? x : tail;
}

// Dynamic shared memory of one block (see Smem).
inline size_t smem_bytes(int FT, int nfft, int nfilters) {
  const int nh = nfft / 2;
  return region_bytes(FT, nfft, nfilters) +
         sizeof(double2) * 2 * table_entries(nh) +
         sizeof(float2) * (nh / 2) + sizeof(int2) * nfilters;
}

struct Smem {
  double2* x;       // NS x nh operand pairs; then:
  float* eo;        //   NS x 2 x nh2 DFT rows (row 0 Re, row 1 Im / Re nh2)
  float* power;     //   FT x nh
  float* logmel;    //   FT x nfilters
  double2* ctab;    // cos table (tpad)
  double2* stab;    // -sin table (tpad)
  float2* tw;       // nh2 twiddles (cos, sin)(2 pi j/nfft)
  int2* band;       // nfilters [lo, hi)
  int nh, log2nh;
  int xs;           // row stride of sm.x: nh + kXPad (the pad spreads the
                    // B fragments' 8 signal rows over the banks)
};

__device__ __forceinline__ Smem carve(double2* smem, int FT, int nfft,
                                      int nfilters) {
  Smem sm;
  sm.nh = nfft >> 1;
  sm.log2nh = __ffs(nfft) - 2;
  sm.xs = sm.nh + kXPad;
  const int nh = sm.nh;
  sm.x = smem;
  sm.eo = reinterpret_cast<float*>(smem);
  sm.power = sm.eo + 2 * FT * nh;
  sm.logmel = sm.power + FT * nh;
  sm.ctab = smem + region_bytes(FT, nfft, nfilters) / sizeof(double2);
  sm.stab = sm.ctab + table_entries(nh);
  sm.tw = reinterpret_cast<float2*>(sm.stab + table_entries(nh));
  sm.band = reinterpret_cast<int2*>(sm.tw + (nh >> 1));
  return sm;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The DFT operand of v: (v, 0) at 6 passes; (hi + lo, lo) at 3 and 4
// (lo = 0 at 4: only 3 passes subtracts lo*lo).
template <int PASSES>
__device__ __forceinline__ double2 operand(float v) {
  if (PASSES == 6) return make_double2(static_cast<double>(v), 0.0);
  const float hi = bf16_round(v);
  const float lo = bf16_round(__fsub_rn(v, hi));
  return make_double2(static_cast<double>(hi) + static_cast<double>(lo),
                      PASSES == 3 ? static_cast<double>(lo) : 0.0);
}

// Copy the tables (as operand pairs), twiddles and band limits into shared
// memory (no barrier: the ingest's closing barrier covers it).
template <int PASSES>
__device__ __forceinline__ void load_constants(const Smem& sm,
                                               const float* __restrict__ cos_t,
                                               const float* __restrict__ sin_t,
                                               const float2* __restrict__ tw,
                                               const int2* __restrict__ band,
                                               int nfilters) {
  for (int i = threadIdx.x; i < sm.nh; i += blockDim.x) {
    sm.ctab[tpad(i)] = operand<PASSES>(cos_t[i]);
    sm.stab[tpad(i)] = operand<PASSES>(sin_t[i]);
  }
  for (int i = threadIdx.x; i < (sm.nh >> 1); i += blockDim.x) sm.tw[i] = tw[i];
  for (int i = threadIdx.x; i < nfilters; i += blockDim.x) sm.band[i] = band[i];
}

// The ingest's store: pre-emphasized samples y[2m], y[2m+1] of frame f of
// the tile, windowed in f32 and split into operands.
template <int PASSES>
__device__ __forceinline__ void put_pair(const Smem& sm, int f, int m, float ye,
                                         float yo, const float* __restrict__ we,
                                         const float* __restrict__ wo) {
  sm.x[(2 * f) * sm.xs + m] = operand<PASSES>(__fmul_rn(ye, we[m]));
  sm.x[(2 * f + 1) * sm.xs + m] = operand<PASSES>(__fmul_rn(yo, wo[m]));
}

// A zero frame slot (past the last frame).
__device__ __forceinline__ void put_zero(const Smem& sm, int f, int m) {
  sm.x[(2 * f) * sm.xs + m] = make_double2(0.0, 0.0);
  sm.x[(2 * f + 1) * sm.xs + m] = make_double2(0.0, 0.0);
}

// d += a * b on the FP64 tensor cores: an 8x4 (row) by 4x8 (col) product
// into an 8x8 accumulator.  Lane l holds A[l/4][l%4], B[l%4][l/4] and
// D[l/4][2(l%4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// 1. The DFT rows of every signal.  Row r of the nh rows is (w, j) with
//    w = r / nh2, j = r % nh2: w = 0 is cos j, w = 1 is -sin j, except that
//    (1, 0), whose -sin row is zero, is the cos row of j = nh2.  Warp q
//    takes row tiles q*RT .. q*RT + RT-1 against all ST signal tiles.  Ends
//    with the rows in sm.eo and a barrier.
template <int PASSES, int ST>
__device__ __forceinline__ void split_dft(const Smem& sm) {
  constexpr int RT = 8 / ST;
  const int nh = sm.nh, nh2 = nh >> 1, mask = nh - 1, xs = sm.xs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int stab = static_cast<int>(sm.stab - sm.ctab);
  int idx[RT], step[RT], toff[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = (warp * RT + i) * 8 + g;
    const int w = r >= nh2, j = r - w * nh2;
    const int jj = (w && j == 0) ? nh2 : j;
    toff[i] = (w && j) ? stab : 0;
    idx[i] = (jj * t) & mask;          // column m = t of k-step 0
    step[i] = (4 * jj) & mask;         // 4 columns per k-step
  }
  double acc[RT][ST][2];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[i][s][0] = acc[i][s][1] = 0.0;

  const double2* xb = sm.x + g * xs + t;   // signal 8 s + g, column k0 + t
  for (int k0 = 0; k0 < nh; k0 += 4) {
    double2 a[RT], b[ST];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      a[i] = sm.ctab[toff[i] + tpad(idx[i])];
      idx[i] = (idx[i] + step[i]) & mask;
    }
#pragma unroll
    for (int s = 0; s < ST; ++s) b[s] = xb[s * 8 * xs + k0];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        dmma(acc[i][s], a[i].x, b[s].x);
        if (PASSES == 3) dmma(acc[i][s], -a[i].y, b[s].y);
      }
  }
  __syncthreads();   // every operand read before the rows overwrite them
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = (warp * RT + i) * 8 + g;
    const int w = r >= nh2, j = r - w * nh2;
#pragma unroll
    for (int s = 0; s < ST; ++s)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int sig = s * 8 + 2 * t + c;
        sm.eo[(sig * 2 + w) * nh2 + j] = __double2float_rn(acc[i][s][c]);
      }
  }
  __syncthreads();
}

__device__ __forceinline__ float sq_sum(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

// Everything after the ingest, which has filled sm.x (and the constants)
// and ended with a barrier: the DFT, recombination, power, mel, floor,
// log2 and the DCT, storing cepstra of tile frames f0 + f < F at
// out[(f0 + f) * ncep + c].
template <int PASSES, int ST>
__device__ __forceinline__ void radix2_tail(const Smem& sm, int FT,
                                            int nfilters, int ncep,
                                            const float* __restrict__ mel,
                                            const float* __restrict__ dct,
                                            float mel_floor,
                                            float* __restrict__ out, int f0,
                                            int F) {
  const int nh = sm.nh, nh2 = nh >> 1;
  split_dft<PASSES, ST>(sm);

  // 2. twiddle recombination and power: A_j -> bin j, B_j -> bin nh - j.
  for (int b = threadIdx.x; b < FT * nh2; b += blockDim.x) {
    const int f = b / nh2;
    const int j = b - f * nh2;
    const float* e = sm.eo + (2 * f) * 2 * nh2;
    const float* o = e + 2 * nh2;
    const float ere = e[j], ore = o[j];
    const float eim = j ? e[nh2 + j] : 0.0f;
    const float oim = j ? o[nh2 + j] : 0.0f;
    const float2 w = sm.tw[j];
    const float tre = __fadd_rn(__fmul_rn(w.x, ore), __fmul_rn(w.y, oim));
    const float tim = __fsub_rn(__fmul_rn(w.x, oim), __fmul_rn(w.y, ore));
    float* p = sm.power + f * nh;
    p[j] = sq_sum(__fadd_rn(ere, tre), __fadd_rn(eim, tim));
    if (j)
      p[nh - j] = sq_sum(__fsub_rn(ere, tre), __fsub_rn(eim, tim));
    else
      p[nh2] = sq_sum(e[nh2], o[nh2]);   // Re E_nh2, Re O_nh2 (j = 0 slot)
  }
  __syncthreads();

  // 3. mel product over each filter's band [lo, hi), floor, log2.
  for (int o = threadIdx.x; o < FT * nfilters; o += blockDim.x) {
    const int f = o / nfilters;
    const int m = o - f * nfilters;
    const float* p = sm.power + f * nh;
    const int2 bd = sm.band[m];
    float acc = 0.0f;
    for (int k = bd.x; k < bd.y; ++k) acc = fmaf(p[k], mel[k * nfilters + m], acc);
    if (mel_floor != 0.0f) acc = fmaxf(acc, mel_floor);
    sm.logmel[o] = log2f(acc);
  }
  __syncthreads();

  // 4. DCT product ((nfilters, ncep) row-major) and the store.
  for (int o = threadIdx.x; o < FT * ncep; o += blockDim.x) {
    const int f = o / ncep;
    const int c = o - f * ncep;
    const int g = f0 + f;
    if (g >= F) continue;
    const float* lm = sm.logmel + f * nfilters;
    float acc = 0.0f;
    for (int m = 0; m < nfilters; ++m) acc = fmaf(lm[m], dct[m * ncep + c], acc);
    out[static_cast<long long>(g) * ncep + c] = acc;
  }
}

// Call f(P, ST) with P = passes and ST = signal_tiles(nfft) as
// std::integral_constant values: the launchers instantiate their kernel
// for the runtime passes and nfft through it.
template <typename F>
int dispatch(int passes, int nfft, F&& f) {
  auto by_tiles = [&](auto p) {
    switch (signal_tiles(nfft)) {
      case 4: return f(p, std::integral_constant<int, 4>{});
      case 2: return f(p, std::integral_constant<int, 2>{});
      default: return f(p, std::integral_constant<int, 1>{});
    }
  };
  switch (passes) {
    case 3: return by_tiles(std::integral_constant<int, 3>{});
    case 4: return by_tiles(std::integral_constant<int, 4>{});
    default: return by_tiles(std::integral_constant<int, 6>{});
  }
}

// The device pointers of the tables every split-DFT entry point takes
// (see float_fused.cu for their contents).
struct Tables {
  const float *cos_t, *sin_t, *we, *wo, *tw, *mel, *dct;
  const int* band;
};

// Host checks shared by every split-DFT launch: nfft in {256, 512, 1024},
// passes in {3, 4, 6}; returns false otherwise.
inline bool geometry_ok(int nfft, int passes, int nfilters, int ncep) {
  return (nfft == 256 || nfft == 512 || nfft == 1024) &&
         (passes == 3 || passes == 4 || passes == 6) && nfilters >= 1 &&
         ncep >= 1;
}

}  // namespace radix2_stages
