// Fused float MFCC for Hopper (sm_90a): (S, T) int16 or f32 audio ->
// (S, F, ncep) f32 cepstra, in one kernel.
//
// Replaces the TPU kernel mfcc_tpu/ops/pallas_fladder.py:_fblk_kernel and
// _fladder_tail (with the radix-2 ladder _fladder_half): the same function,
// not the same block structure.  Per frame:
//   pre-emphasis y = x - 0.96875*prev -> window * 1/nfft -> FFT -> |X|^2 on
//   bins [0, nfft/2) -> mel product -> optional max(mel, mel_floor) ->
//   log2 -> DCT product,
// every stage inside this kernel, the products as FMA loops.  Everything
// after the ingest is the device code of fladder_stages.cuh, which the
// float serving step (stream_step.cu) shares.
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

#include "fladder_stages.cuh"

namespace {

using namespace fladder_stages;

constexpr double kEmph = 0.96875;   // 1 - 1/32

__device__ __forceinline__ double to_f64(int16_t v) { return static_cast<double>(v); }
__device__ __forceinline__ double to_f64(float v) { return static_cast<double>(v); }

template <typename In>
__global__ void __launch_bounds__(kThreads)
fladder_kernel(const In* __restrict__ audio, float* __restrict__ out,
               long long T, int F, int hop, int log2n, int nfilters, int ncep,
               int frames_per_block, long long tiles_per_stream,
               const double* __restrict__ win, const double2* __restrict__ tw,
               const double* __restrict__ mel, const double* __restrict__ dct,
               const int2* __restrict__ band, double mel_floor) {
  extern __shared__ double2 smem[];
  const int FT = frames_per_block;
  const int log2m = log2n - 1;
  const int M = 1 << log2m;
  const Smem sm = carve(smem, FT, log2n, nfilters);

  const long long s = blockIdx.x / tiles_per_stream;
  const int f0 = static_cast<int>(blockIdx.x % tiles_per_stream) * FT;
  const In* x = audio + s * T;

  load_constants(sm, tw, band, M, nfilters);

  // ingest: pre-emphasis and window * 1/nfft on sample pairs, packed as
  // z[m] = y[2m] + i*y[2m+1].
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
    sm.buf[f * sm.R + pad(m)] = z;
  }
  __syncthreads();

  ladder_tail(sm, FT, log2n, nfilters, ncep, mel, dct, mel_floor,
              out + s * F * ncep, f0, F);
}

template <typename In>
int launch(const In* audio, float* out, long long S, long long T, int F,
           int hop, int nfft, int nfilters, int ncep, const double* win,
           const double* tw, const double* mel, const double* dct,
           const int* band, double mel_floor, void* stream) {
  const int log2n = log2_nfft(nfft);
  if (log2n < 0 || F < 1 || hop < 1 || nfilters < 1 ||
      ncep < 1 || S < 0 || T < static_cast<long long>(F - 1) * hop + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const int FT = frames_per_block(nfft);
  const long long tiles = (F + FT - 1) / FT;
  const long long blocks = S * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(FT, nfft, nfilters);
  const int err = allow_smem(fladder_kernel<In>, smem);
  if (err != 0) return err;
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
