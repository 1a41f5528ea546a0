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
// Design.  One block of 256 threads (8 warps) per (stream, tile of FT =
// 16384/nfft frames: 32 at nfft 512).  Framing is addressing, as in K1: the
// block first copies the tile's input span (~5.8k samples, eight loads in
// flight a thread) into shared memory and builds its frames from there (no
// framing pass; a load per sample in the build loop left each of them
// waiting on memory, with one block per SM to hide it).  The frames are
// FP64 rows in shared memory (row stride = 4 mod 16 doubles, so a B
// fragment's 8 rows x 4 columns hit each bank twice, the least for 256
// bytes).  The operator is streamed from device memory (1 MB in f32 at nfft
// 512, resident in L2) in K-tiles of 8192/nfft rows by cp.async into two
// shared stages (row stride nfft + 8 floats: the A fragment's 4 rows land
// on distinct banks).  The product runs on the FP64 tensor cores in the
// m16n8k4 shape that sm_90 added (half the instructions of m8n8k4 for the
// same work): warp w owns bins [w nb/8, (w+1) nb/8) in both halves of the
// operator (re and im), nb/64 tiles of 16 operator columns in each, against
// all FT/8 tiles of 8 frames, so its accumulators (64 doubles a thread, no
// spills: 180-199 registers) hold the re and im of the same bins and the
// power is taken in registers.  The power rows then reuse the frames'
// shared memory, and K1's mel/log2 and DCT device functions
// (fladder_stages.cuh) finish the tile.
//
// What bounds it, at the headline (S=1024 x T=63,922 int16, nfft 512, hop
// 170: 382,976 frames): the DFT's 2 K nfft FP64 operations a frame, 2.0e11
// in all, 3.0 ms at the FP64 tensor cores' 67 TFLOP/s; HBM moves 131 MB in
// and 49 MB out (0.05 ms).  Next, the operator's reads from L2: 1 MB per
// block, ~12 GB a call.  The TPU's BF=128-frame static slices, (8, 10880)
// tile-aligned chunks, hop-row recomposition, segment operators and
// positions-major layouts are layouts of the same product and are not
// carried.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fladder_stages.cuh"   // allow_smem, mel_log2, dct_store
#include "radix2_stages.cuh"    // bf16_round

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePoints = 16384;   // FT * nfft
constexpr int kStagePoints = 8192;   // KT * nfft
constexpr float kEmph = 0.96875f;    // 1 - 1/32
constexpr size_t kMaxSmem = 232448;  // a block's limit on sm_90
constexpr int kU = 8;                // ingest loads in flight a thread

enum Ingest { kEmphasized = 0, kEmphasize = 1, kFold = 2 };

__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// hi + lo of v's two bf16 limbs (both round to nearest even); exact in f32.
__device__ __forceinline__ float limb_sum(float v) {
  const float hi = radix2_stages::bf16_round(v);
  return __fadd_rn(hi, radix2_stages::bf16_round(__fsub_rn(v, hi)));
}

// d += a * b on the FP64 tensor cores, m16n8k4: lane l holds A[l/4][l%4]
// (a0) and A[l/4 + 8][l%4] (a1), B[l%4][l/4], and D[l/4][2(l%4) + {0, 1}]
// (d0, d1), D[l/4 + 8][2(l%4) + {0, 1}] (d2, d3).
__device__ __forceinline__ void dmma16(double (&d)[4], double a0, double a1,
                                       double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Geometry of one launch, computed on the host.
struct Geometry {
  int nfft, nb, K;   // operator rows K = nfft (+1 folded)
  int FT;            // frames per block
  int KT;            // operator rows per stage
  int nkt;           // stages of the K loop: ceil(K / KT)
  int kpad;          // frame row extent filled (zeros past K): ceil32(K)
  int fstride;       // frame row stride in doubles: kpad + 4
  int ostride;       // operator stage row stride in floats: nfft + 8
  size_t frames_bytes, stage_bytes, smem;
};

inline Geometry geometry(int nfft, int hop, int nfilters, int ingest) {
  Geometry g;
  g.nfft = nfft;
  g.nb = nfft / 2;
  g.K = nfft + (ingest == kFold ? 1 : 0);
  g.FT = kTilePoints / nfft;
  g.KT = kStagePoints / nfft;
  g.nkt = (g.K + g.KT - 1) / g.KT;
  g.kpad = (g.K + 31) / 32 * 32;
  g.fstride = g.kpad + 4;
  g.ostride = nfft + 8;
  const size_t power = sizeof(double) * g.FT * g.nb;
  const size_t frames = sizeof(double) * g.FT * g.fstride;
  g.frames_bytes = frames > power ? frames : power;
  const size_t stages = sizeof(float) * 2 * g.KT * g.ostride;
  const size_t logmel = sizeof(double) * g.FT * nfilters;
  const size_t span = sizeof(float) * ((g.FT - 1) * static_cast<size_t>(hop) + nfft + 1);
  g.stage_bytes = stages > logmel ? stages : logmel;
  if (span > g.stage_bytes) g.stage_bytes = (span + 15) / 16 * 16;
  g.smem = g.frames_bytes + g.stage_bytes + sizeof(int2) * nfilters;
  return g;
}

// Stage kt of the operator (rows kt*KT .. kt*KT + KT - 1, zeros past K) into
// shared buffer `stage`, 16 bytes a copy.
__device__ __forceinline__ void load_stage(float* stage,
                                           const float* __restrict__ cs,
                                           const Geometry& geo, int kt) {
  const int chunks = geo.nfft >> 2;
  for (int i = threadIdx.x; i < geo.KT * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const int row = kt * geo.KT + r;
    float* dst = stage + r * geo.ostride + 4 * c;
    if (row < geo.K)
      cp_async16(dst, cs + static_cast<long long>(row) * geo.nfft + 4 * c);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// CH tiles of 16 operator columns in each half (re, im) per warp and NT
// tiles of 8 frames per block: (1, 8), (2, 4), (4, 2) at nfft 256, 512, 1024.
template <typename In, int CH, int NT>
__global__ void __launch_bounds__(kThreads, 1)
dense_kernel(const In* __restrict__ audio, float* __restrict__ out, long long T,
             int F, int hop, Geometry geo, int nfilters, int ncep, int ingest,
             int split, const float* __restrict__ cs,
             const double* __restrict__ mel, const double* __restrict__ dct,
             const int2* __restrict__ band, double mel_floor) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* frames = reinterpret_cast<double*>(smem);
  double* power = frames;                       // after the product
  float* stages = reinterpret_cast<float*>(smem + geo.frames_bytes);
  double* logmel = reinterpret_cast<double*>(stages);   // after the product
  int2* sband = reinterpret_cast<int2*>(smem + geo.frames_bytes + geo.stage_bytes);
  const int FT = NT * 8;
  const int stage_floats = geo.KT * geo.ostride;

  const long long tiles = (F + FT - 1) / FT;
  const long long s = blockIdx.x / tiles;
  const int f0 = static_cast<int>(blockIdx.x % tiles) * FT;
  const In* x = audio + s * T;

  // The tile's samples x[f0*hop - 1 .. last needed], as f32, into the
  // stages' memory (free until the K loop starts), kU loads in flight a
  // thread; x[-1] is 0.
  float* span = stages;
  const int nvalid = F - f0 < FT ? F - f0 : FT;
  const int nspan = (nvalid - 1) * hop + geo.nfft + 1;
  const long long t0 = static_cast<long long>(f0) * hop - 1;
  for (int i0 = threadIdx.x; i0 < nspan; i0 += kU * kThreads) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      const long long t = t0 + i;
      v[u] = (i < nspan && t >= 0) ? to_f32(x[t]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (i0 + u * kThreads < nspan) span[i0 + u * kThreads] = v[u];
  }
  for (int i = threadIdx.x; i < nfilters; i += blockDim.x) sband[i] = band[i];
  __syncthreads();
  for (int i = threadIdx.x; i < FT * geo.kpad; i += blockDim.x) {
    const int f = i / geo.kpad;
    const int p = i - f * geo.kpad;
    float v = 0.0f;
    if (p < geo.K && f < nvalid) {
      const float* y = span + f * hop + p;   // y[1] is frame sample p
      v = ingest == kFold ? y[0]
          : ingest == kEmphasize ? __fsub_rn(y[1], __fmul_rn(kEmph, y[0]))
                                 : y[1];
      if (split) v = limb_sum(v);
    }
    frames[f * geo.fstride + p] = static_cast<double>(v);
  }
  __syncthreads();   // the span is read before the stages are loaded
  load_stage(stages, cs, geo, 0);
  cp_async_commit();

  // The product: warp w, lane (q = lane/4, t = lane%4).  A fragment j holds
  // operator columns col(j) + q and col(j) + q + 8 at row k + t (tiles j <
  // CH of the re half, the rest of the im half); B fragment n is frame
  // 8n + q at position k + t; D[j][n] holds columns col(j) + q (d0, d1) and
  // col(j) + q + 8 (d2, d3) of frames 8n + 2t and 8n + 2t + 1.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, t = lane & 3;
  const int bw = geo.nb / kWarps;               // bins per warp: 16 CH
  const int col_re = warp * bw + q;
  const int col_im = geo.nb + col_re;
  double acc[2 * CH][NT][4];
#pragma unroll
  for (int j = 0; j < 2 * CH; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][n][c] = 0.0;

  const double* fb = frames + q * geo.fstride + t;
  for (int kt = 0; kt < geo.nkt; ++kt) {
    if (kt + 1 < geo.nkt)
      load_stage(stages + ((kt + 1) & 1) * stage_floats, cs, geo, kt + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* st = stages + (kt & 1) * stage_floats + t * geo.ostride;
    const double* fk = fb + kt * geo.KT;
#pragma unroll 4
    for (int kk = 0; kk < geo.KT; kk += 4) {
      double b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) b[n] = fk[n * 8 * geo.fstride + kk];
      const float* sr = st + kk * geo.ostride;
#pragma unroll
      for (int j = 0; j < 2 * CH; ++j) {
        const int col = (j < CH ? col_re : col_im) + 16 * (j % CH);
        const double a0 = static_cast<double>(sr[col]);
        const double a1 = static_cast<double>(sr[col + 8]);
#pragma unroll
        for (int n = 0; n < NT; ++n) dmma16(acc[j][n], a0, a1, b[n]);
      }
    }
    __syncthreads();
  }

  // Power in registers, stored as FT rows of nb bins over the frames.
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bin = col_re + 16 * j + 8 * h;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const double re = acc[j][n][2 * h + c], im = acc[j + CH][n][2 * h + c];
          power[(8 * n + 2 * t + c) * geo.nb + bin] =
              __dadd_rn(__dmul_rn(re, re), __dmul_rn(im, im));
        }
    }
  __syncthreads();
  fladder_stages::mel_log2(power, FT, geo.nb, nfilters, sband, mel, mel_floor,
                           logmel);
  __syncthreads();
  fladder_stages::dct_store(logmel, FT, nfilters, ncep, dct, out + s * F * ncep,
                            f0, F);
}

template <typename In, int CH, int NT>
int launch(const In* audio, float* out, long long S, long long T, int F,
           int hop, const Geometry& geo, int nfilters, int ncep, int ingest,
           int split, const float* cs, const double* mel, const double* dct,
           const int* band, double mel_floor, void* stream) {
  const long long tiles = (F + geo.FT - 1) / geo.FT;
  if (S * tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const int err = fladder_stages::allow_smem(dense_kernel<In, CH, NT>, geo.smem);
  if (err != 0) return err;
  dense_kernel<In, CH, NT><<<static_cast<unsigned>(S * tiles), kThreads,
                             geo.smem, static_cast<cudaStream_t>(stream)>>>(
      audio, out, T, F, hop, geo, nfilters, ncep, ingest, split, cs, mel, dct,
      reinterpret_cast<const int2*>(band), mel_floor);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_dense(const In* audio, float* out, long long S, long long T, int F,
                 int hop, int nfft, int nfilters, int ncep, int ingest,
                 int split, const float* cs, const double* mel,
                 const double* dct, const int* band, double mel_floor,
                 void* stream) {
  // the last frame reads samples up to (F-1)*hop + nfft - 1 in every mode
  if ((nfft != 256 && nfft != 512 && nfft != 1024) || ingest < 0 ||
      ingest > 2 || F < 1 || hop < 1 || S < 0 || nfilters < 1 || ncep < 1 ||
      T < static_cast<long long>(F - 1) * hop + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = geometry(nfft, hop, nfilters, ingest);
  if (geo.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  switch (nfft) {
    case 256:
      return launch<In, 1, 8>(audio, out, S, T, F, hop, geo, nfilters, ncep,
                              ingest, split, cs, mel, dct, band, mel_floor,
                              stream);
    case 512:
      return launch<In, 2, 4>(audio, out, S, T, F, hop, geo, nfilters, ncep,
                              ingest, split, cs, mel, dct, band, mel_floor,
                              stream);
    default:
      return launch<In, 4, 2>(audio, out, S, T, F, hop, geo, nfilters, ncep,
                               ingest, split, cs, mel, dct, band, mel_floor,
                               stream);
  }
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  cs is the (K, nfft) float32 operator,
// row-major, 16-byte aligned: columns [0, nfft/2) the windowed cos rows of
// bins 0 .. nfft/2 - 1 and [nfft/2, nfft) the -sin rows, K = nfft, or
// nfft + 1 for ingest 2 (the folded CS2); with split it holds the limb sums
// of those values.  mel (nfft/2 x nfilters) and dct (nfilters x ncep) are
// float64, row-major; band nfilters int32 pairs [lo, hi) outside which a mel
// column is zero.  ingest 0 takes f32 audio only.  Launches on `stream`, on
// the calling thread's current device (the caller sets it), without
// synchronizing; returns a cudaError_t (0 = launched).
extern "C" int mfcc_dense_i16(const int16_t* audio, float* out, long long S,
                              long long T, int F, int hop, int nfft,
                              int nfilters, int ncep, int ingest, int split,
                              const float* cs, const double* mel,
                              const double* dct, const int* band,
                              double mel_floor, void* stream) {
  if (ingest == kEmphasized) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dense(audio, out, S, T, F, hop, nfft, nfilters, ncep, ingest,
                      split, cs, mel, dct, band, mel_floor, stream);
}

extern "C" int mfcc_dense_f32(const float* audio, float* out, long long S,
                              long long T, int F, int hop, int nfft,
                              int nfilters, int ncep, int ingest, int split,
                              const float* cs, const double* mel,
                              const double* dct, const int* band,
                              double mel_floor, void* stream) {
  return launch_dense(audio, out, S, T, F, hop, nfft, nfilters, ncep, ingest,
                      split, cs, mel, dct, band, mel_floor, stream);
}
