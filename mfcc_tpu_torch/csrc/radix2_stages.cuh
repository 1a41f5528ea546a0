// Device functions of the split-DFT float MFCC tail: the window on the even
// and odd frame positions, the nfft/2-point DFT of each half as a product
// with the cos / -sin operator in the form dft_passes selects, twiddle
// recombination, power on bins [0, nfft/2), the banded mel sum with floor
// and log2, and the DCT product with the f32 store.  Shared by K5
// (float_fused.cu: from raw audio, and from frames) and the split-DFT
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
// (hi+lo)(hi+lo) is one product on the FP64 tensor cores of
// dmma_product.cuh, every term exact in FP64; at 3 passes the lo*lo
// correction is summed on the bf16 tensor cores in f32 (each lo*lo is
// exact in f32: 8-bit significands) and subtracted once, before the single
// rounding to f32.  Its f32 sum errs by at most nh 2^-24 of sum |lo lo|,
// which is <= 2^-16 sum |x c|: <= 2^-31 sum |x c| at nh 256, far below the
// f32 rounding of the result that the plain version (float64 throughout)
// sees.  6 passes is the plain f32 operands' product, exact in FP64.  The
// TPU sums in f32; on quiet mel bands of long inputs two f32 summation
// orders differ by ~1.5e-3 after log2 (a numpy emulation of this loop
// against torch's sgemm on 8 streams x 4 s), which would make kernel and
// plain version unverifiable against each other, so the main sum is FP64
// here and in the plain version.
//
// The engine streams the dense nh x nh operator (rows [0, nh2] cos j, rows
// (nh2, nh) -sin j, as float_fused.radix2_operators builds it for the plain
// version too) in fragment order: at 3 passes first its bf16 lo limbs (a
// k16 chunk layout), then hi + lo as OpT; at 4 hi + lo; at 6 the values.
// Output column r of the product is dense row r, stored at eo[sig nh + r]:
// positions [0, nh2) the cos rows j (Re), [nh2, nh) the -sin rows (Im),
// slot nh2 (whose -sin row is zero) the cos row of j = nh2.
//
// Layout of the block's dynamic shared memory (FT frames a tile, NS = 2 FT
// signals, signal 2f + h being half h of frame f): NS FP64 operand rows
// (stride nh + 4), reused after the product for the NS x nh f32 DFT rows,
// the FT x nh power rows and the FT x nfilters log-mel rows; at 3 passes NS
// bf16 lo rows (stride nh + 8: a B fragment's 8 rows x 4 words hit 32
// banks); the ring; its barriers; the nh2 twiddles (cos, sin), the mel
// band limits, the mel band weights (filter m's from moff[m]), the DCT and
// the tile's frame table.  FT = 16384/nfft (32 at nfft 512: 64 signals, 8
// tiles of 8 against each warp's CT = nh/128 column tiles, 64 FP64
// accumulators a thread).  At nfft 512: 130 KB of rows, 33 KB of lo rows,
// three 16 KB stages (four at 4 and 6 passes), 7 KB of tables; 222-255
// registers a thread.
//
// Tiles are FT consecutive frames of the flattened (streams x frames) list
// (frame G is stream G / F, frame G % F, from the tile's frame table), so a
// short stream or the serving step's 7 frames a stream fill whole tiles.
// The ingests keep eight sample pairs' loads in flight a thread, and each
// CTA prefetches its next tile's input into L2 before the product.  After
// the product a warp finishes FT/8 frames: lane m the mel sum of filter m
// for all of them (one weight load each k), lane c cepstrum c; the weights
// and the DCT sit in shared memory, since L1 beside 220 KB of shared
// memory cannot hold them.
//
// What bounds it: the FP64 product, nh^2 multiply-adds per signal, 2.6e5
// per frame at nfft 512, 1.0e11 operations at the headline (1.5 ms at 67
// TFLOP/s), against ~2e4 per frame for the rest of the tail and ~2e3 bf16
// tensor-core operations per signal row of the correction.  The old
// design's losses and what this one does: (1) m8n8k4 -> m16n8k4, twice the
// work an instruction; (2) an A fragment looked up in the circulant tables
// per row tile per k-step -> the dense operator streamed in fragment
// order, one vector load a fragment; (3) 8 frames a block, tables reloaded
// by 48k blocks -> 32 frames a tile on a persistent grid, the tables once
// per block; (4) the lo*lo term as a second FP64 MMA -> one bf16 MMA per
// 16 k; (5) the tail not overlapped -> the ring holds the next tile's
// first chunks while it runs.  Measured (PERF.md): the product 61%
// of the cycles at 6 passes, the ingest 25% (its input reads 13%), the
// tail 14%; the bf16 correction pass costs ~1 ms at 3 passes, far over its
// operations, in chunk synchronisation and the lo rows' stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "dmma_product.cuh"

namespace radix2_stages {

using namespace dmma_product;

constexpr int kTilePoints = 16384;   // FT * nfft per tile
constexpr int kXPad = 4;             // pad doubles per FP64 row
constexpr int kLoPad = 8;            // pad bf16 per lo row

// Frames per tile: 64, 32, 16 at nfft 256, 512, 1024.
inline int frames_per_tile(int nfft) { return kTilePoints / nfft; }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Geometry of one launch, computed on the host.
struct Geometry {
  int nfft, nh, FT;
  int KC, nmain;        // FP64-product rows per chunk, its chunks
  int KCl, nlo;         // bf16 lo rows per chunk, its chunks (3 passes)
  int stages;
  uint32_t stage_bytes;
  size_t xlo_off, ring_off, bar_off, tw_off, band_off, melc_off, moff_off,
      dct_off, fr_off, smem;
};

inline size_t up16(size_t v) { return (v + 15) / 16 * 16; }

// Returns false where the shape or the operator does not fit.
inline bool geometry(Geometry& g, int nfft, int nfilters, int ncep,
                     int mel_len, int passes, const Operator& o) {
  g.nfft = nfft;
  g.nh = nfft / 2;
  g.FT = frames_per_tile(nfft);
  g.stage_bytes = chunk_bytes(o, g.nh, g.nh);
  if (g.stage_bytes == 0 || o.rows != g.nh || mel_len < 1) return false;
  g.KC = o.chunk_rows;
  g.nmain = g.nh / g.KC;
  g.KCl = static_cast<int>(g.stage_bytes / (2 * g.nh));
  g.nlo = passes == 3 ? g.nh / g.KCl : 0;
  if (passes == 3 && (g.KCl % 16 || g.nh % g.KCl)) return false;
  const int NS = 2 * g.FT;
  const size_t x = sizeof(double) * NS * (g.nh + kXPad);
  const size_t tail = sizeof(float) * (3 * g.FT * g.nh + g.FT * nfilters);
  const size_t xlo = passes == 3 ? sizeof(__nv_bfloat16) * NS * (g.nh + kLoPad) : 0;
  // after the ring: its barriers, the twiddles, band limits, mel weights
  // and offsets, the dct and the tile's frame table
  const size_t tables = barrier_bytes() + up16(sizeof(float2) * (g.nh / 2)) +
                        up16(sizeof(int2) * nfilters) + up16(sizeof(float) * mel_len) +
                        up16(sizeof(int) * nfilters) +
                        up16(sizeof(float) * nfilters * ncep) + up16(sizeof(int2) * g.FT);
  g.xlo_off = up16(x > tail ? x : tail);
  g.ring_off = g.xlo_off + up16(xlo);
  g.stages = ring_stages(g.ring_off + tables - barrier_bytes(), g.stage_bytes);
  if (g.stages < 2) return false;
  g.bar_off = g.ring_off + static_cast<size_t>(g.stages) * g.stage_bytes;
  g.tw_off = up16(g.bar_off + barrier_bytes());
  g.band_off = g.tw_off + up16(sizeof(float2) * (g.nh / 2));
  g.melc_off = g.band_off + up16(sizeof(int2) * nfilters);
  g.moff_off = g.melc_off + up16(sizeof(float) * mel_len);
  g.dct_off = g.moff_off + up16(sizeof(int) * nfilters);
  g.fr_off = g.dct_off + up16(sizeof(float) * nfilters * ncep);
  g.smem = g.fr_off + up16(sizeof(int2) * g.FT);
  return g.smem <= kMaxSmem;
}

struct Smem {
  double* x;            // NS x xs operand rows; then:
  float* eo;            //   NS x nh DFT rows
  float* power;         //   FT x nh
  float* logmel;        //   FT x nfilters
  __nv_bfloat16* xlo;   // NS x xls lo limbs (3 passes)
  float2* tw;           // nh2 twiddles (cos, sin)(2 pi j/nfft)
  int2* band;           // nfilters [lo, hi)
  float* melw;          // the band weights, filter m's from moff[m]
  int* moff;            // nfilters
  float* dct;           // nfilters x ncep
  int2* fr;             // FT (stream, frame) of the tile's frames
  Ring ring;
  int nh, log2nh, FT, xs, xls;
};

__device__ __forceinline__ Smem carve(unsigned char* smem, const Geometry& g) {
  Smem sm;
  sm.nh = g.nh;
  sm.log2nh = __ffs(g.nfft) - 2;
  sm.FT = g.FT;
  sm.xs = g.nh + kXPad;
  sm.xls = g.nh + kLoPad;
  sm.x = reinterpret_cast<double*>(smem);
  sm.eo = reinterpret_cast<float*>(smem);
  sm.power = sm.eo + 2 * g.FT * g.nh;
  sm.logmel = sm.power + g.FT * g.nh;
  sm.xlo = reinterpret_cast<__nv_bfloat16*>(smem + g.xlo_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  sm.ring = make_ring(smem + g.ring_off, bars, g.stages, g.stage_bytes);
  sm.tw = reinterpret_cast<float2*>(smem + g.tw_off);
  sm.band = reinterpret_cast<int2*>(smem + g.band_off);
  sm.melw = reinterpret_cast<float*>(smem + g.melc_off);
  sm.moff = reinterpret_cast<int*>(smem + g.moff_off);
  sm.dct = reinterpret_cast<float*>(smem + g.dct_off);
  sm.fr = reinterpret_cast<int2*>(smem + g.fr_off);
  return sm;
}

// The tile's frame table: (G / F, G % F) of frames G = G0 + f < M, F
// frames a stream, (-1, 0) past M; ends with a barrier.
__device__ __forceinline__ void frame_table(const Smem& sm, long long G0,
                                            long long M, int F) {
  for (int f = threadIdx.x; f < sm.FT; f += kConsumers) {
    const long long G = G0 + f;
    sm.fr[f] = G < M ? make_int2(static_cast<int>(G / F), static_cast<int>(G % F))
                     : make_int2(-1, 0);
  }
  consumer_sync();
}

// The ingest's store: pre-emphasized samples y[2m], y[2m+1] of frame f of
// the tile, windowed in f32 and split into operands.
template <int PASSES>
__device__ __forceinline__ void put_pair(const Smem& sm, int f, int m, float ye,
                                         float yo, const float* __restrict__ we,
                                         const float* __restrict__ wo) {
  const float v[2] = {__fmul_rn(ye, we[m]), __fmul_rn(yo, wo[m])};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 2 * f + h;
    if (PASSES == 6) {
      sm.x[row * sm.xs + m] = static_cast<double>(v[h]);
    } else {
      const float hi = bf16_round(v[h]);
      const float lo = bf16_round(__fsub_rn(v[h], hi));
      sm.x[row * sm.xs + m] = static_cast<double>(hi) + static_cast<double>(lo);
      if (PASSES == 3) sm.xlo[row * sm.xls + m] = __float2bfloat16_rn(lo);
    }
  }
}

// A zero frame slot (past the last frame).
template <int PASSES>
__device__ __forceinline__ void put_zero(const Smem& sm, int f, int m) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sm.x[(2 * f + h) * sm.xs + m] = 0.0;
    if (PASSES == 3) sm.xlo[(2 * f + h) * sm.xls + m] = __float2bfloat16_rn(0.0f);
  }
}

// 1. The DFT rows of every signal: the engine's product (at 3 passes the
//    bf16 lo*lo sum first, its negation the accumulators' start), each
//    rounded to f32 once into sm.eo.  Ends with a barrier.
template <int PASSES, int CT, int NT>
__device__ __forceinline__ void split_dft(const Smem& sm, const Geometry& geo,
                                          Cursor& cu, const Producer& pr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  double acc[CT][NT][4];
  if (PASSES == 3) {
    float corr[CT][NT][4];
    bf16_chunks<CT, NT>(corr, sm.xlo, sm.xls, sm.ring, cu, pr, geo.nlo,
                        geo.KCl);
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][n][c] = -static_cast<double>(corr[j][n][c]);
  } else {
    zero(acc);
  }
  fp64_chunks<CT, NT>(acc, sm.x, sm.xs, sm.ring, cu, pr, geo.nmain, geo.KC);
  consumer_sync();   // every operand read before the rows overwrite them
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 16 * (warp * CT + j) + g + 8 * (c >> 1);
        const int sig = 8 * n + 2 * t + (c & 1);
        sm.eo[sig * sm.nh + col] = __double2float_rn(acc[j][n][c]);
      }
  consumer_sync();
}

__device__ __forceinline__ float sq_sum(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

// Everything after the ingest, which has filled the operand rows and ended
// with a barrier: the DFT, recombination, power, mel, floor, log2 and the
// DCT, storing cepstra of tile frames G0 + f < M at out[(G0 + f) * ncep +
// c].  Ends with a barrier, so the next tile's ingest may follow.
template <int PASSES, int CT, int NT>
__device__ __forceinline__ void radix2_tail(const Smem& sm, const Geometry& geo,
                                            Cursor& cu, const Producer& pr,
                                            int nfilters, int ncep,
                                            float mel_floor,
                                            float* __restrict__ out,
                                            long long G0, long long M) {
  const int nh = sm.nh, nh2 = nh >> 1, FT = sm.FT;
  split_dft<PASSES, CT, NT>(sm, geo, cu, pr);

  // 2. twiddle recombination and power: A_j -> bin j, B_j -> bin nh - j.
  for (int b = threadIdx.x; b < FT * nh2; b += kConsumers) {
    const int f = b >> (sm.log2nh - 1);
    const int j = b & (nh2 - 1);
    const float* e = sm.eo + (2 * f) * nh;
    const float* o = e + nh;
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
  consumer_sync();

  // 3. warp w finishes frames [w FW, (w + 1) FW), FW = NT/2 (NT counts
  //    tiles of 8 signals, two a frame): lane m sums filter m
  //    over its band [lo, hi) for all of them at once (one weight load
  //    each k), floor, log2; then lane c the DCT product ((nfilters, ncep)
  //    row-major) of cepstrum c and the store.
  constexpr int FW = NT / 2;
  const int lane = threadIdx.x & 31, fw = (threadIdx.x >> 5) * FW;
  for (int m = lane; m < nfilters; m += 32) {
    const int2 bd = sm.band[m];
    const float* w = sm.melw + sm.moff[m] - bd.x;   // w[k] = mel[k, m]
    const float* p = sm.power + fw * nh;
    float acc[FW];
#pragma unroll
    for (int q = 0; q < FW; ++q) acc[q] = 0.0f;
    for (int k = bd.x; k < bd.y; ++k) {
      const float wk = w[k];
#pragma unroll
      for (int q = 0; q < FW; ++q) acc[q] = fmaf(p[q * nh + k], wk, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < FW; ++q) {
      const float v = mel_floor != 0.0f ? fmaxf(acc[q], mel_floor) : acc[q];
      sm.logmel[(fw + q) * nfilters + m] = log2f(v);
    }
  }
  __syncwarp();
  for (int c = lane; c < ncep; c += 32) {
    const float* lm = sm.logmel + fw * nfilters;
    float acc[FW];
#pragma unroll
    for (int q = 0; q < FW; ++q) acc[q] = 0.0f;
    for (int m = 0; m < nfilters; ++m) {
      const float d = sm.dct[m * ncep + c];
#pragma unroll
      for (int q = 0; q < FW; ++q) acc[q] = fmaf(lm[q * nfilters + m], d, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < FW; ++q)
      if (G0 + fw + q < M) out[(G0 + fw + q) * ncep + c] = acc[q];
  }
  consumer_sync();   // the rows read before the next tile's ingest
}

// The tables every split-DFT entry point takes (see float_fused.cu for
// their contents): device pointers, and the mel weights' count.
struct Tables {
  const float *we, *wo, *tw, *melw;
  const int* moff;
  const float* dct;
  const int* band;
  int mel_len;
};

// The body of every split-DFT kernel: M frames in tiles of FT, on the
// persistent grid of launch_persistent; ingest(sm, G0) fills the
// operand rows of frames G0 .. G0 + FT - 1 (zeros at G >= M) with
// put_pair / put_zero and ends with consumer_sync(); prefetch(sm, G0)
// prefetches the input of the tile from G0 into L2 (or nothing).
template <int PASSES, int CT, int NT, typename Ingest, typename Prefetch>
__device__ __forceinline__ void run(unsigned char* smem, const Geometry& geo,
                                    long long M, const OpT* __restrict__ op,
                                    const Tables& tb, int nfilters, int ncep,
                                    float mel_floor, float* __restrict__ out,
                                    Ingest ingest, Prefetch prefetch) {
  const Smem sm = carve(smem, geo);
  const long long ntiles = (M + geo.FT - 1) / geo.FT;
  const int iters = turns(ntiles);
  const int nchunks = geo.nlo + geo.nmain;

  ring_init(sm.ring);
  const float2* tw = reinterpret_cast<const float2*>(tb.tw);
  const int2* band = reinterpret_cast<const int2*>(tb.band);
  for (int i = threadIdx.x; i < (sm.nh >> 1); i += kThreads) sm.tw[i] = tw[i];
  for (int i = threadIdx.x; i < nfilters; i += kThreads) {
    sm.band[i] = band[i];
    sm.moff[i] = tb.moff[i];
  }
  for (int i = threadIdx.x; i < tb.mel_len; i += kThreads) sm.melw[i] = tb.melw[i];
  for (int i = threadIdx.x; i < nfilters * ncep; i += kThreads) sm.dct[i] = tb.dct[i];
  consumer_sync();

  const Producer pr = producer(op, nchunks, iters * nchunks);
  prime(sm.ring, pr);
  Cursor cu;
  for (int it = 0; it < iters; ++it) {
    const long long tile = blockIdx.x + static_cast<long long>(it) * gridDim.x;
    const long long G0 = tile * geo.FT;
    ingest(sm, G0);
    const long long next = tile + gridDim.x;
    if (next < ntiles) prefetch(sm, next * geo.FT);
    radix2_tail<PASSES, CT, NT>(sm, geo, cu, pr, nfilters, ncep, mel_floor,
                                out, G0, M);
  }
}

// Call f(P, CT, NT) with P = passes, CT = nfft/256 column tiles a warp and
// NT = 2 FT / 8 signal tiles as std::integral_constant values: the
// launchers instantiate their kernel for the runtime passes and nfft
// through it.
template <typename F>
int dispatch(int passes, int nfft, F&& f) {
  auto by_nfft = [&](auto p) {
    using std::integral_constant;
    switch (nfft) {
      case 256: return f(p, integral_constant<int, 1>{}, integral_constant<int, 16>{});
      case 512: return f(p, integral_constant<int, 2>{}, integral_constant<int, 8>{});
      default: return f(p, integral_constant<int, 4>{}, integral_constant<int, 4>{});
    }
  };
  switch (passes) {
    case 3: return by_nfft(std::integral_constant<int, 3>{});
    case 4: return by_nfft(std::integral_constant<int, 4>{});
    default: return by_nfft(std::integral_constant<int, 6>{});
  }
}

// Host checks shared by every split-DFT launch: nfft in {256, 512, 1024},
// passes in {3, 4, 6}; returns false otherwise.
inline bool geometry_ok(int nfft, int passes, int nfilters, int ncep) {
  return (nfft == 256 || nfft == 512 || nfft == 1024) &&
         (passes == 3 || passes == 4 || passes == 6) && nfilters >= 1 &&
         ncep >= 1;
}

// Launch `kernel` (one of the split-DFT kernels, instantiated at PASSES,
// CT, NT) over M frames; the trailing arguments follow its own leading
// ones.
template <typename Kernel, typename... Args>
int launch_r2(Kernel kernel, long long M, int nfft, int nfilters, int ncep,
              int passes, const Operator& o, const Tables& tb, void* stream,
              Args... args) {
  Geometry geo;
  if (!geometry(geo, nfft, nfilters, ncep, tb.mel_len, passes, o))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const long long ntiles = (M + geo.FT - 1) / geo.FT;
  return launch_persistent(kernel, kThreads, ntiles, geo.smem, stream, geo,
                           M, static_cast<const OpT*>(o.data), args...);
}

}  // namespace radix2_stages
