// Fused float MFCC for Hopper (sm_90a): (S, T) int16 or f32 audio ->
// (S, F, ncep) f32 cepstra, in one kernel.
//
// Replaces the TPU kernel mfcc_tpu/ops/pallas_fladder.py:_fblk_kernel and
// _fladder_tail (with the radix-2 ladder _fladder_half): the same function,
// not the same block structure.  Per frame:
//   pre-emphasis y = x - 0.96875*prev -> window * 1/nfft -> FFT -> |X|^2 on
//   bins [0, nfft/2) -> mel product -> optional max(mel, mel_floor) ->
//   log2 -> DCT product,
// every stage inside this kernel, the products as FMA loops.
//
// Precision: the interior runs in FP64 and the result is rounded to f32
// once, at the store.  The TPU kernel computes in f32 because the TPU has
// no FP64.  An f32 FFT's absolute error is ~1e-7 of the frame's energy,
// while low mel bands of pre-emphasized audio hold down to ~1e-8 of it, and
// log2 amplifies the difference.  On 8 streams x 4 s of the headline input
// the TPU kernel's f32 arithmetic (run in interpret mode on a CPU) reads
// 3.4e-4 against the float64 oracle and an early f32 radix-2 variant of
// this kernel 5.1e-4, against a 5e-4 gate; the final structure has not
// been read in f32.  In FP64 the emphasis is exact for int16 and f32
// samples alike and the output sits within f32 rounding of the oracle.
//
// Design, one thread block per (stream, tile of frames):
//  * a tile is 1024/(nfft/2) frames (4 at nfft 512); each frame loads its
//    nfft samples and the one before its start (0 at t = 0) straight from
//    the input, so overlapped framing is addressing; int16 stays int16;
//  * real-input packing: z[m] = y[2m] + i*y[2m+1], an nfft/2-point complex
//    FFT, then X[k] = (Z[k] + conj Z[-k])/2 + W^k (Z[k] - conj Z[-k])/2i --
//    half the butterflies of a complex nfft-point FFT;
//  * decimation in frequency on the natural-order load, radix-4 passes
//    (two radix-2 stages each, one barrier) and one radix-2 pass when the
//    stage count is odd; outputs come out bit-reversed and are read back
//    through bit-reversed indices in the post-processing;
//  * shared rows carry one pad word per 16, which spreads the bit-reversed
//    reads over the banks (without it they serialize ~8x);
//  * the mel product runs over each filter's nonzero bins only (band
//    limits from the wrapper), ~16x less work than the dense product.
// Offsets are 64-bit: S*T passes 2^31 at S=4096 x 60 s.
//
// What bounds it, per call at the headline size (S=1024 x T=63,922, nfft
// 512, hop 170: 382,976 frames): ~131 MB of int16 in and ~49 MB of f32
// out, ~54 us of HBM time at 3.35 TB/s; ~19.6 kFLOP of FP64 per frame as
// chip_smoke.py counts this kernel's arithmetic, ~7.5 GFLOP per call
// (0.22 ms at the card's 34 TFLOP/s outside the tensor cores, the bound).
// Measured ~2 ms, so neither bound is near: the time goes to
// shared-memory traffic, barriers (7 per block at nfft 512) and latency
// chains in the per-output loops.
//
// Left for later work: register-resident radix-8/16 passes with fewer
// barriers, conflict-free addressing in the small-span passes, more frames
// per block to amortize the prologue, and f32 or double-f32 arithmetic
// where the gate allows it.  The TPU-only structure of the Pallas kernel is
// not carried: its sigma/evenodd8 row order, (8, lanes) sublane blocks with
// the regroup permutation, 128-lane frame tiles, rolls, and the super-block
// chunking with SMEM carries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTilePoints = 1024;   // packed complex points per block
constexpr int kPadShift = 4;        // one pad double2 per 16
constexpr double kEmph = 0.96875;   // 1 - 1/32

__device__ __forceinline__ double to_f64(int16_t v) { return static_cast<double>(v); }
__device__ __forceinline__ double to_f64(float v) { return static_cast<double>(v); }

__device__ __forceinline__ int pad(int p) { return p + (p >> kPadShift); }

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int bitrev(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
fladder_kernel(const In* __restrict__ audio, float* __restrict__ out,
               long long T, int F, int hop, int log2n, int nfilters, int ncep,
               int frames_per_block, long long tiles_per_stream,
               const double* __restrict__ win, const double2* __restrict__ tw,
               const double* __restrict__ mel, const double* __restrict__ dct,
               const int2* __restrict__ band, double mel_floor) {
  extern __shared__ double2 smem[];
  const int nbins = 1 << (log2n - 1);
  const int log2m = log2n - 1;          // packed FFT size M = nfft/2
  const int M = nbins;
  const int R = M + (M >> kPadShift);   // padded row
  const int FT = frames_per_block;
  double2* buf = smem;                                      // FT x R
  double2* stw = buf + FT * R;                              // nbins: W^k
  double* power = reinterpret_cast<double*>(stw + nbins);   // FT x nbins
  double* logmel = power + FT * nbins;                      // FT x nfilters
  int2* sband = reinterpret_cast<int2*>(logmel + FT * nfilters);

  const long long s = blockIdx.x / tiles_per_stream;
  const int f0 = static_cast<int>(blockIdx.x % tiles_per_stream) * FT;
  const In* x = audio + s * T;

  for (int i = threadIdx.x; i < nbins; i += blockDim.x) stw[i] = tw[i];
  for (int i = threadIdx.x; i < nfilters; i += blockDim.x) sband[i] = band[i];

  // 1. ingest: pre-emphasis and window * 1/nfft on sample pairs, packed as
  //    z[m] = y[2m] + i*y[2m+1].
  for (int i = threadIdx.x; i < FT * M; i += blockDim.x) {
    const int f = i >> log2m;
    const int m = i & (M - 1);
    const int g = f0 + f;
    double2 z = make_double2(0.0, 0.0);
    if (g < F) {
      const long long t = static_cast<long long>(g) * hop + 2 * m;
      const double p = t > 0 ? to_f64(x[t - 1]) : 0.0;
      const double a = to_f64(x[t]);
      const double b = to_f64(x[t + 1]);
      z = make_double2((a - kEmph * p) * win[2 * m], (b - kEmph * a) * win[2 * m + 1]);
    }
    buf[f * R + pad(m)] = z;
  }
  __syncthreads();

  // 2. M-point DIF FFT.  A radix-4 pass merges the radix-2 stages of spans
  //    2h and h (group 4h, twiddle w = W_4h^j): outputs b0+b2, (b0-b2) w^2,
  //    (b1+b3) w, (b1-b3) w^3 with b0,b1 = a0 +- a2, b2 = a1 + a3,
  //    b3 = -i (a1 - a3).  W_4h^j = W_nfft^(j << (st + 1)).
  for (int st = 0; st < log2m;) {
    if (log2m - st >= 2) {
      const int l2h = log2m - st - 2;
      const int h = 1 << l2h;
      for (int b = threadIdx.x; b < FT * (M >> 2); b += blockDim.x) {
        const int q = b & ((M >> 2) - 1);
        const int j = q & (h - 1);
        const int i0 = ((q >> l2h) << (l2h + 2)) + j;
        double2* row = buf + (b >> (log2m - 2)) * R;
        const int p0 = pad(i0), p1 = pad(i0 + h), p2 = pad(i0 + 2 * h), p3 = pad(i0 + 3 * h);
        const double2 a0 = row[p0], a1 = row[p1], a2 = row[p2], a3 = row[p3];
        const double2 w = stw[j << (st + 1)];
        const double2 w2 = stw[j << (st + 2)];
        const double2 w3 = cmul(w, w2);
        const double2 b0 = make_double2(a0.x + a2.x, a0.y + a2.y);
        const double2 b1 = make_double2(a0.x - a2.x, a0.y - a2.y);
        const double2 b2 = make_double2(a1.x + a3.x, a1.y + a3.y);
        const double2 b3 = make_double2(a1.y - a3.y, a3.x - a1.x);
        row[p0] = make_double2(b0.x + b2.x, b0.y + b2.y);
        row[p1] = cmul(make_double2(b0.x - b2.x, b0.y - b2.y), w2);
        row[p2] = cmul(make_double2(b1.x + b3.x, b1.y + b3.y), w);
        row[p3] = cmul(make_double2(b1.x - b3.x, b1.y - b3.y), w3);
      }
      st += 2;
    } else {  // last radix-2 stage: span 1, twiddle 1
      for (int b = threadIdx.x; b < FT * (M >> 1); b += blockDim.x) {
        double2* row = buf + (b >> (log2m - 1)) * R;
        const int i0 = 2 * (b & ((M >> 1) - 1));
        const int p0 = pad(i0), p1 = pad(i0 + 1);
        const double2 a = row[p0], c = row[p1];
        row[p0] = make_double2(a.x + c.x, a.y + c.y);
        row[p1] = make_double2(a.x - c.x, a.y - c.y);
      }
      st += 1;
    }
    __syncthreads();
  }

  // 3. unpack the real spectrum (Z[k] sits at bitrev(k)) and take |X|^2.
  for (int b = threadIdx.x; b < FT * nbins; b += blockDim.x) {
    const int f = b >> log2m;
    const int k = b & (nbins - 1);
    const double2* row = buf + f * R;
    const double2 zk = row[pad(bitrev(k, log2m))];
    const double2 zn = row[pad(bitrev((M - k) & (M - 1), log2m))];
    const double2 xe = make_double2(0.5 * (zk.x + zn.x), 0.5 * (zk.y - zn.y));
    const double2 xo = make_double2(0.5 * (zk.y + zn.y), -0.5 * (zk.x - zn.x));
    const double2 wx = cmul(xo, stw[k]);
    const double re = xe.x + wx.x, im = xe.y + wx.y;
    power[f * nbins + k] = re * re + im * im;
  }
  __syncthreads();

  // 4. mel product over each filter's band [lo, hi), floor, log2.
  for (int o = threadIdx.x; o < FT * nfilters; o += blockDim.x) {
    const int f = o / nfilters;
    const int m = o - f * nfilters;
    const double* p = power + f * nbins;
    const int2 bd = sband[m];
    double acc = 0.0;
    for (int k = bd.x; k < bd.y; ++k) acc = fma(p[k], mel[k * nfilters + m], acc);
    if (mel_floor != 0.0) acc = fmax(acc, mel_floor);
    logmel[o] = log2(acc);
  }
  __syncthreads();

  // 5. DCT product ((nfilters, ncep) row-major) and the (S, F, ncep) store.
  for (int o = threadIdx.x; o < FT * ncep; o += blockDim.x) {
    const int f = o / ncep;
    const int c = o - f * ncep;
    const int g = f0 + f;
    if (g >= F) continue;
    const double* lm = logmel + f * nfilters;
    double acc = 0.0;
    for (int m = 0; m < nfilters; ++m) acc = fma(lm[m], dct[m * ncep + c], acc);
    out[(s * F + g) * ncep + c] = static_cast<float>(acc);
  }
}

template <typename In>
int launch(const In* audio, float* out, long long S, long long T, int F,
           int hop, int nfft, int nfilters, int ncep, const double* win,
           const double* tw, const double* mel, const double* dct,
           const int* band, double mel_floor, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < nfft) ++log2n;
  if (nfft < 8 || (1 << log2n) != nfft || F < 1 || hop < 1 || nfilters < 1 ||
      ncep < 1 || S < 0 || T < static_cast<long long>(F - 1) * hop + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const int M = nfft / 2;
  const int FT = M >= kTilePoints ? 1 : kTilePoints / M;
  const long long tiles = (F + FT - 1) / FT;
  const long long blocks = S * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(double2) * (static_cast<size_t>(FT) * (M + (M >> kPadShift)) + M) +
      sizeof(double) * static_cast<size_t>(FT) * (M + nfilters) +
      sizeof(int2) * static_cast<size_t>(nfilters);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fladder_kernel<In>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fladder_kernel<In><<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      audio, out, T, F, hop, log2n, nfilters, ncep, FT, tiles, win,
      reinterpret_cast<const double2*>(tw), mel, dct,
      reinterpret_cast<const int2*>(band), mel_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  win (nfft), mel (nfft/2 x nfilters)
// and dct (nfilters x ncep) are float64, row-major; tw holds nfft/2
// interleaved complex float64 twiddles exp(-2*pi*i*k/nfft); band holds
// nfilters int32 pairs [lo, hi) outside which a mel column is zero.
// Launches on `stream`, on the calling thread's current device (the
// caller sets it), without synchronizing; returns a cudaError_t
// (0 = launched).
extern "C" int mfcc_fladder_i16(const int16_t* audio, float* out, long long S,
                                long long T, int F, int hop, int nfft,
                                int nfilters, int ncep, const double* win,
                                const double* tw, const double* mel,
                                const double* dct, const int* band,
                                double mel_floor, void* stream) {
  return launch(audio, out, S, T, F, hop, nfft, nfilters, ncep, win, tw, mel,
                dct, band, mel_floor, stream);
}

extern "C" int mfcc_fladder_f32(const float* audio, float* out, long long S,
                                long long T, int F, int hop, int nfft,
                                int nfilters, int ncep, const double* win,
                                const double* tw, const double* mel,
                                const double* dct, const int* band,
                                double mel_floor, void* stream) {
  return launch(audio, out, S, T, F, hop, nfft, nfilters, ncep, win, tw, mel,
                dct, band, mel_floor, stream);
}
