// K8 for Hopper (sm_90a): the float MFCC with the real DFT as a dense
// product against the windowed DFT operator, one kernel behind the seven
// entry points of ops/dense_fused.py.
//
//  mfcc_dense_{i16,f32}:  (S, T) int16 or f32 audio -> (S, F, ncep) f32.
//      Replaces the six TPU kernels of mfcc_tpu/ops/pallas_mfcc.py that
//      multiply frames by the (nfft, nfft) operator CS: _mfcc_kernel
//      (entries mfcc_pallas_emphasized, mfcc_batch_pallas), _mfcc_raw_kernel
//      (mfcc_pallas_raw), _mfcc_aligned_kernel (mfcc_pallas_aligned),
//      _mfcc_recomp_kernel (mfcc_pallas_recomp), _mfcc_seg_kernel
//      (mfcc_pallas_seg) and _mfcc_fmaj_kernel (mfcc_pallas_fmaj).  They
//      differ in their TPU layouts, in where the emphasis happens and in
//      the DFT's precision; here these are three knobs:
//        ingest 0 "emphasized": the input is emphasized f32 audio;
//        ingest 1 "emphasize":  raw audio, emphasized in f32 as
//                               x - 0.96875f*p rounded twice;
//        ingest 2 "fold":       raw audio against the 513-row operator CS2
//                               with the emphasis folded in (frame g is
//                               raw[g*hop - 1 .. g*hop + nfft - 1], raw[-1]
//                               = 0);
//        split: each operand replaced by hi + lo, its two bf16 limbs (round
//               to nearest even; hi + lo is exact in f32), as the TPU's four
//               bf16 passes take it.  The wrapper hands the operator in
//               already split; the kernel splits the frames at ingest;
//        mel_floor: the mel sums are floored before log2 when it is not 0.
//
// The function, shared with the plain version: f32 frames of K samples
// (K = nfft, or nfft + 1 folded), reim = frames @ CS summed in FP64 (every
// product of two f32 values is exact in FP64, so a split product is the
// TPU's four limb products exactly), power on bins [0, nfft/2) (the Nyquist
// mel row is zero), the banded mel sum, floor, log2 and the DCT in FP64,
// rounded to f32 once.  The TPU sums in f32; two f32 summation orders
// differ by ~1e-5 after log2 of the quiet bands, so the port sums in FP64
// to hold the kernel to its plain version.
//
// Design: the product runs on the engine of dmma_product.cuh (see there
// for the ring and its refills).  A tile is FT = 16384/nfft frames of one
// stream (32 at nfft 512); the grid is persistent, one block an SM.
// The consumers ingest a tile in groups of frames whose input span fits
// the span buffer (two groups at nfft 512 and hop 170): the span
// as f32 into shared memory (eight loads in flight a thread), then the
// frames as FP64 rows from it, zeros past K and past the stream's last
// frame.  The operator comes in fragment order from the wrapper (columns
// permuted so that tile 2i is the cos columns of bins [16i, 16i + 16) and
// tile 2i + 1 their -sin columns), its K padded with zero rows to whole
// chunks; warp w owns tiles [w CT, (w + 1) CT), CT = nfft/128, so its
// accumulators hold the re and im of the same bins and the power is taken
// in registers.  The power rows and the log-mel rows then reuse the
// frames' memory, and each warp finishes NT frames (warp_tail: lane m the
// mel sum of filter m for all of them, lane c cepstrum c), with the mel
// band weights and the DCT in shared memory: L1 beside 220 KB of shared
// memory cannot hold the 64 KB FP64 mel matrix, and a global read per
// weight left each sum waiting on L2.
//
// Budget at nfft 512: frames 32 x 516 doubles (132 KB; 532 folded), two
// 32 KB ring stages (16 operator rows each), the span (up to 23 KB: 30
// frames' input at hop 170, so two ingest groups), 13 KB of tables, 256
// threads, one block per SM, 248 registers a thread; 64 FP64 accumulators
// a thread.
//
// What bounds it, at the headline (S=1024 x T=63,922 int16, nfft 512, hop
// 170: 382,976 frames): the DFT's 2 K nfft FP64 operations a frame, 2.0e11
// in all, 3.0 ms at the FP64 tensor cores' 67 TFLOP/s; HBM moves 131 MB in
// and 49 MB out (0.05 ms).  The old design's four losses and what this one
// does about each: (1) one block of 8 warps per SM with nothing beside
// the ingest and tail -> the ring holds the next tile's first chunks
// while they run, and the next tile's input is prefetched into L2; (2) a
// two-stage cp.async ring with two __syncthreads per 16 rows -> an
// mbarrier ring, no block barrier in the K loop; (3) the operator's L2
// reads, 1 MB per block, ~12.9 GB a call -> left as they are: multicast
// to a cluster measured no gain (dmma_product.cuh), they were not the
// limit; (4)
// a conversion per A element beside 16-byte shared loads of two rows ->
// one 8-byte fragment-order load per A fragment (f32, converted: an FP64
// operator measured slower).  Measured (PERF.md): the product 72%
// of the cycles at 70-74% of the MMA rate, the ingest 17%, the tail 10%.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma_product.cuh"
#include "radix2_stages.cuh"    // bf16_round

namespace {

using namespace dmma_product;

constexpr int kTilePoints = 16384;   // FT * nfft
constexpr float kEmph = 0.96875f;    // 1 - 1/32
constexpr int kU = 8;                // ingest loads in flight a thread

enum Ingest { kEmphasized = 0, kEmphasize = 1, kFold = 2 };

__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// hi + lo of v's two bf16 limbs (both round to nearest even); exact in f32.
__device__ __forceinline__ float limb_sum(float v) {
  const float hi = radix2_stages::bf16_round(v);
  return __fadd_rn(hi, radix2_stages::bf16_round(__fsub_rn(v, hi)));
}

// Frames [fw, fw + NT) of the tile, one warp's share: lane m sums filter m
// over its band [lo, hi) of `band` (weights mel[lo .. hi - 1, m] at
// melw[moff[m] ..]) for all NT frames at once from the power rows (row f
// at power + f * nbins), floor, log2; then lane c the DCT product
// ((nfilters, ncep) row-major) of cepstrum c, rounded to f32 once, stored
// for tile frames f0 + f < F at out[(f0 + f) * ncep + c].
template <int NT>
__device__ __forceinline__ void warp_tail(const double* power, int nbins,
                                          int nfilters, int ncep,
                                          const int2* band, const int* moff,
                                          const double* melw, const double* dct,
                                          double mel_floor, double* logmel,
                                          float* __restrict__ out, int f0,
                                          int F, int fw) {
  const int lane = threadIdx.x & 31;
  for (int m = lane; m < nfilters; m += 32) {
    const int2 bd = band[m];
    const double* w = melw + moff[m] - bd.x;   // w[k] = mel[k, m]
    const double* p = power + fw * nbins;
    double acc[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) acc[q] = 0.0;
    for (int k = bd.x; k < bd.y; ++k) {
      const double wk = w[k];
#pragma unroll
      for (int q = 0; q < NT; ++q) acc[q] = fma(p[q * nbins + k], wk, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const double v = mel_floor != 0.0 ? fmax(acc[q], mel_floor) : acc[q];
      logmel[(fw + q) * nfilters + m] = log2(v);
    }
  }
  __syncwarp();
  for (int c = lane; c < ncep; c += 32) {
    const double* lm = logmel + fw * nfilters;
    double acc[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) acc[q] = 0.0;
    for (int m = 0; m < nfilters; ++m) {
      const double d = dct[m * ncep + c];
#pragma unroll
      for (int q = 0; q < NT; ++q) acc[q] = fma(lm[q * nfilters + m], d, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < NT; ++q)
      if (f0 + fw + q < F)
        out[static_cast<long long>(f0 + fw + q) * ncep + c] = static_cast<float>(acc[q]);
  }
}

// Geometry of one launch, computed on the host.
struct Geometry {
  int nfft, nb, K;     // operator rows K = nfft (+1 folded)
  int FT;              // frames per tile
  int kpad;            // operator rows with the zero pad: nchunks * KC
  int KC, nchunks;     // rows per chunk, chunks per tile
  int fstride;         // frame row stride in doubles: ceil16(kpad) + 4
  int G;               // frames per ingest group
  size_t frames_bytes, span_bytes, ring_off, bar_off, band_off, moff_off,
      melw_off, dct_off, smem;
  uint32_t stage_bytes;
  int stages;
};

inline size_t up16(size_t v) { return (v + 15) / 16 * 16; }

// Returns false where the shape does not fit a block.
inline bool geometry(Geometry& g, int nfft, int hop, int nfilters, int ncep,
                     int mel_len, int ingest, const Operator& o) {
  g.nfft = nfft;
  g.nb = nfft / 2;
  g.K = nfft + (ingest == kFold ? 1 : 0);
  g.FT = kTilePoints / nfft;
  g.stage_bytes = chunk_bytes(o, g.K, nfft);
  if (g.stage_bytes == 0) return false;
  g.KC = o.chunk_rows;
  g.kpad = o.rows;
  g.nchunks = o.rows / o.chunk_rows;
  g.fstride = (g.kpad + 15) / 16 * 16 + 4;
  // after the product the power rows, then the log-mel rows
  const size_t power = sizeof(double) * g.FT * (g.nb + nfilters);
  const size_t frames = sizeof(double) * g.FT * g.fstride;
  g.frames_bytes = up16(frames > power ? frames : power);
  const size_t one = sizeof(float) * (nfft + 1);
  const size_t full = sizeof(float) *
      ((g.FT - 1) * static_cast<size_t>(hop) + nfft + 1);
  // band limits, mel band weights and offsets, the dct
  const size_t tables = up16(sizeof(int2) * nfilters) + up16(sizeof(int) * nfilters) +
                        up16(sizeof(double) * mel_len) +
                        up16(sizeof(double) * nfilters * ncep);
  if (mel_len < 1) return false;
  // the most stages that leave the span room for a frame; the span takes
  // the rest, up to the tile's whole input
  for (g.stages = kMaxStages; g.stages >= 2; --g.stages) {
    const size_t fixed = g.frames_bytes + barrier_bytes() + tables +
                         static_cast<size_t>(g.stages) * g.stage_bytes;
    if (fixed >= kMaxSmem) continue;
    const size_t left = (kMaxSmem - fixed) / 16 * 16;
    if (left < one) continue;
    g.span_bytes = left < full ? left : up16(full);
    break;
  }
  if (g.stages < 2) return false;
  g.G = (static_cast<int>(g.span_bytes / sizeof(float)) - nfft - 1) / hop + 1;
  if (g.G > g.FT) g.G = g.FT;
  g.ring_off = g.frames_bytes + g.span_bytes;
  g.bar_off = g.ring_off + static_cast<size_t>(g.stages) * g.stage_bytes;
  g.band_off = g.bar_off + barrier_bytes();
  g.moff_off = g.band_off + up16(sizeof(int2) * nfilters);
  g.melw_off = g.moff_off + up16(sizeof(int) * nfilters);
  g.dct_off = g.melw_off + up16(sizeof(double) * mel_len);
  g.smem = g.dct_off + up16(sizeof(double) * nfilters * ncep);
  return g.smem <= kMaxSmem;
}

// CT tiles of 16 operator columns per warp (re and im alternating), NT
// tiles of 8 frames per block: (2, 8), (4, 4), (8, 2) at nfft 256, 512,
// 1024.
template <typename In, int CT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
dense_kernel(const In* __restrict__ audio, float* __restrict__ out, long long T,
             int F, int hop, Geometry geo, long long ntiles,
             int tiles_per_stream, int nfilters, int ncep, int ingest,
             int split, const OpT* __restrict__ op,
             const double* __restrict__ melw, const int* __restrict__ moff,
             const double* __restrict__ dct, const int2* __restrict__ band,
             int mel_len, double mel_floor) {
  extern __shared__ __align__(16) unsigned char dense_smem[];
  unsigned char* smem = dense_smem;
  double* frames = reinterpret_cast<double*>(smem);
  double* power = frames;                       // after the product
  double* logmel = power + NT * 8 * geo.nb;
  float* span = reinterpret_cast<float*>(smem + geo.frames_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + geo.bar_off);
  int2* sband = reinterpret_cast<int2*>(smem + geo.band_off);
  int* smoff = reinterpret_cast<int*>(smem + geo.moff_off);
  double* smelw = reinterpret_cast<double*>(smem + geo.melw_off);
  double* sdct = reinterpret_cast<double*>(smem + geo.dct_off);
  const Ring ring = make_ring(smem + geo.ring_off, bars, geo.stages,
                              geo.stage_bytes);
  constexpr int FT = NT * 8;
  const int iters = turns(ntiles);

  ring_init(ring);
  for (int i = threadIdx.x; i < nfilters; i += kThreads) {
    sband[i] = band[i];
    smoff[i] = moff[i];
  }
  for (int i = threadIdx.x; i < mel_len; i += kThreads) smelw[i] = melw[i];
  for (int i = threadIdx.x; i < nfilters * ncep; i += kThreads) sdct[i] = dct[i];
  consumer_sync();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Producer pr = producer(op, geo.nchunks, iters * geo.nchunks);
  prime(ring, pr);
  Cursor cu;
  for (int it = 0; it < iters; ++it) {
    const long long tile = blockIdx.x + static_cast<long long>(it) * gridDim.x;
    const long long s = tile / tiles_per_stream;
    const int f0 = static_cast<int>(tile % tiles_per_stream) * FT;
    const In* x = audio + s * T;
    const int nvalid = F - f0 < FT ? F - f0 : FT;

    // ingest: groups of G frames; the span x[(f0 + fg)*hop - 1 ..] as f32
    // (x[-1] = 0), then the FP64 rows, zeros past K and past nvalid
    for (int fg = 0; fg < FT; fg += geo.G) {
      const int nf = FT - fg < geo.G ? FT - fg : geo.G;
      const int nin = nvalid - fg < nf ? nvalid - fg : nf;
      const int nspan = nin > 0 ? (nin - 1) * hop + geo.nfft + 1 : 0;
      const long long t0 = static_cast<long long>(f0 + fg) * hop - 1;
      for (int i0 = threadIdx.x; i0 < nspan; i0 += kU * kConsumers) {
        float v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int i = i0 + u * kConsumers;
          const long long tt = t0 + i;
          v[u] = (i < nspan && tt >= 0) ? to_f32(x[tt]) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (i0 + u * kConsumers < nspan) span[i0 + u * kConsumers] = v[u];
      }
      consumer_sync();
      for (int f = 0; f < nf; ++f)
        for (int p = threadIdx.x; p < geo.kpad; p += kConsumers) {
          float v = 0.0f;
          if (p < geo.K && f < nin) {
            const float* y = span + f * hop + p;   // y[1] is frame sample p
            v = ingest == kFold ? y[0]
                : ingest == kEmphasize ? __fsub_rn(y[1], __fmul_rn(kEmph, y[0]))
                                       : y[1];
            if (split) v = limb_sum(v);
          }
          frames[(fg + f) * geo.fstride + p] = static_cast<double>(v);
        }
      consumer_sync();
    }

    // the next tile's input into L2 while this one's product runs
    const long long next = tile + gridDim.x;
    if (next < ntiles) {
      const long long sn = next / tiles_per_stream;
      const long long tn = (next % tiles_per_stream) * FT * hop;
      const long long t0n = tn > 0 ? tn - 1 : 0;
      const long long t1n = tn + static_cast<long long>(FT - 1) * hop + geo.nfft;
      prefetch_l2(audio + sn * T + t0n,
                  sizeof(In) * ((t1n < T ? t1n : T) - t0n), threadIdx.x,
                  kThreads);
    }

    double acc[CT][NT][4];
    zero(acc);
    fp64_chunks<CT, NT>(acc, frames, geo.fstride, ring, cu, pr, geo.nchunks,
                        geo.KC);
    consumer_sync();   // every frame read before the power overwrites them

    // power in registers: tiles 2j (re) and 2j + 1 (im) of bins
    // 16 (warp CT/2 + j) + g (+ 8)
#pragma unroll
    for (int j = 0; j < CT / 2; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int bin = 16 * (warp * (CT / 2) + j) + g + 8 * (c >> 1);
          const double re = acc[2 * j][n][c], im = acc[2 * j + 1][n][c];
          power[(8 * n + 2 * t + (c & 1)) * geo.nb + bin] =
              __dadd_rn(__dmul_rn(re, re), __dmul_rn(im, im));
        }
    consumer_sync();
    warp_tail<NT>(power, geo.nb, nfilters, ncep, sband, smoff, smelw, sdct,
                  mel_floor, logmel, out + s * F * ncep, f0, F, warp * NT);
    consumer_sync();   // the power and log-mel rows read before the next frames
  }
}

template <typename In, int CT, int NT>
int launch(const In* audio, float* out, long long S, long long T, int F,
           int hop, const Geometry& geo, int nfilters, int ncep, int ingest,
           int split, const OpT* op, const double* melw, const int* moff,
           const double* dct, const int* band, int mel_len, double mel_floor,
           void* stream) {
  const int tps = (F + geo.FT - 1) / geo.FT;
  const long long ntiles = S * tps;
  if (S == 0) return 0;
  return launch_persistent(dense_kernel<In, CT, NT>, kThreads, ntiles,
                           geo.smem, stream, audio, out, T, F, hop, geo,
                           ntiles, tps, nfilters, ncep, ingest, split, op,
                           melw, moff, dct,
                           reinterpret_cast<const int2*>(band), mel_len,
                           mel_floor);
}

template <typename In>
int launch_dense(const In* audio, float* out, long long S, long long T, int F,
                 int hop, int nfft, int nfilters, int ncep, int ingest,
                 int split, const Operator& op, const double* melw,
                 const int* moff, const double* dct, const int* band,
                 int mel_len, double mel_floor, void* stream) {
  // the last frame reads samples up to (F-1)*hop + nfft - 1 in every mode
  if ((nfft != 256 && nfft != 512 && nfft != 1024) || ingest < 0 ||
      ingest > 2 || F < 1 || hop < 1 || S < 0 || nfilters < 1 || ncep < 1 ||
      T < static_cast<long long>(F - 1) * hop + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry geo;
  if (!geometry(geo, nfft, hop, nfilters, ncep, mel_len, ingest, op))
    return static_cast<int>(cudaErrorInvalidValue);
  const OpT* o = static_cast<const OpT*>(op.data);
  switch (nfft) {
    case 256:
      return launch<In, 2, 8>(audio, out, S, T, F, hop, geo, nfilters, ncep,
                              ingest, split, o, melw, moff, dct, band,
                              mel_len, mel_floor, stream);
    case 512:
      return launch<In, 4, 4>(audio, out, S, T, F, hop, geo, nfilters, ncep,
                              ingest, split, o, melw, moff, dct, band,
                              mel_len, mel_floor, stream);
    default:
      return launch<In, 8, 2>(audio, out, S, T, F, hop, geo, nfilters, ncep,
                              ingest, split, o, melw, moff, dct, band,
                              mel_len, mel_floor, stream);
  }
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  op is the (K, nfft) operator in the
// engine's fragment order (ops/dmma_product.py): op_rows >= K rows (zero
// past K, a whole number of chunk_rows-row chunks), its columns [0,
// nfft/2) the windowed cos rows of bins 0 .. nfft/2 - 1 and [nfft/2, nfft)
// the -sin rows, permuted into re/im tile pairs, K = nfft, or nfft + 1 for
// ingest 2 (the folded CS2); with split it holds the limb sums of those
// values.  band holds nfilters
// int32 pairs [lo, hi) outside which a column of the (nfft/2 x nfilters)
// float64 mel matrix is zero, melw its mel_len band weights (filter m's
// mel[lo .. hi - 1, m] from melw[moff[m]]), dct the (nfilters x ncep)
// float64 DCT, row-major.  ingest 0 takes f32
// audio only.  Launches on `stream`, on the calling thread's current
// device (the caller sets it), without synchronizing; returns a
// cudaError_t (0 = launched).
extern "C" int mfcc_dense_i16(const int16_t* audio, float* out, long long S,
                              long long T, int F, int hop, int nfft,
                              int nfilters, int ncep, int ingest, int split,
                              const void* op, int op_rows, int chunk_rows,
                              const double* melw, const int* moff,
                              const double* dct, const int* band,
                              int mel_len, double mel_floor, void* stream) {
  if (ingest == kEmphasized) return static_cast<int>(cudaErrorInvalidValue);
  const Operator o{op, op_rows, chunk_rows};
  return launch_dense(audio, out, S, T, F, hop, nfft, nfilters, ncep, ingest,
                      split, o, melw, moff, dct, band, mel_len, mel_floor,
                      stream);
}

extern "C" int mfcc_dense_f32(const float* audio, float* out, long long S,
                              long long T, int F, int hop, int nfft,
                              int nfilters, int ncep, int ingest, int split,
                              const void* op, int op_rows, int chunk_rows,
                              const double* melw, const int* moff,
                              const double* dct, const int* band,
                              int mel_len, double mel_floor, void* stream) {
  const Operator o{op, op_rows, chunk_rows};
  return launch_dense(audio, out, S, T, F, hop, nfft, nfilters, ncep, ingest,
                      split, o, melw, moff, dct, band, mel_len, mel_floor,
                      stream);
}

// The dynamic shared memory and ring stages a launch of mfcc_dense_* with
// these arguments takes (0 and 0 where it would be refused).
extern "C" int mfcc_dense_smem(int nfft, int hop, int nfilters, int ncep,
                               int mel_len, int ingest, const void* op,
                               int op_rows, int chunk_rows, long long* smem,
                               int* stages) {
  const Operator o{op, op_rows, chunk_rows};
  Geometry geo;
  const bool ok = geometry(geo, nfft, hop, nfilters, ncep, mel_len, ingest, o);
  *smem = ok ? static_cast<long long>(geo.smem) : 0;
  *stages = ok ? geo.stages : 0;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
