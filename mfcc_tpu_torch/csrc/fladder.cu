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
// Design (fladder_stages.cuh): a persistent grid (persistent.cuh) of blocks
// of 8 warps, as many as the card holds; a block loads its twiddle and mel
// tables into shared memory once, and each warp then takes frames G = s*F
// + g in a grid-stride loop, one frame at a time, at every nfft:
//  * the warp loads its frame's nfft samples and the one before its start
//    (0 at t = 0) straight from the input, so overlapped framing is
//    addressing; int16 stays int16;
//  * real-input packing: z[m] = y[2m] + i*y[2m+1] goes straight into
//    registers, lane l holding z[l + 32r]; an nfft/2-point complex FFT,
//    then X[k] = (Z[k] + conj Z[-k])/2 + W^k (Z[k] - conj Z[-k])/2i --
//    half the butterflies of a complex nfft-point FFT;
//  * the FFT in registers, 8 complex points a lane at nfft 512, radix-2
//    decimation in frequency in passes of 3 + 3 + 2 stages with two
//    exchanges through the warp's swizzled shared row (no bank
//    conflicts); the unpack and power; the mel sums a lane per filter over
//    its nonzero bins (~16x less work than the dense product); log2; the
//    DCT a lane per cepstrum, stored coalesced.  No block barrier after
//    the tables'.
// Offsets are 64-bit: S*T passes 2^31 at S=4096 x 60 s.
//
// What bounds it, per call at the headline size (S=1024 x T=63,922, nfft
// 512, hop 170: 382,976 frames): ~131 MB of int16 in and ~49 MB of f32
// out, ~54 us of HBM time at 3.35 TB/s; ~19.6 kFLOP of FP64 per frame as
// chip_smoke.py counts the function (the FFT as radix-4 passes), ~7.5
// GFLOP per call (0.22 ms at the card's 34 TFLOP/s outside the tensor
// cores, the bound).  This design is bound by instruction issue: ~2.5k
// SASS instructions a warp issues per frame straight-line (tools/
// sass_mix.py on the nfft-512 kernel), ~0.45k more in the mel, log2 and DCT
// loops, ~1.06 ms at one warp instruction a clock per scheduler; of
// them ~730 FP64 (the FP64 pipe ~half busy), ~460 IMAD and ~210 LOP3 of
// address and index work, ~190 shared loads and stores.  A design with a
// block per 4 frames and radix-4 passes through shared memory, 7 barriers
// a block, makes ~5.5k 16-byte shared accesses a frame and takes ~2 ms.
//
// Left for later work: the mel loop (balanced bands, conflict-free power
// reads), radix-4 passes in registers, and f32 or double-f32 arithmetic
// where the gate allows it.  The TPU-only structure of the Pallas kernel is
// not carried: its sigma/evenodd8 row order, (8, lanes) sublane blocks with
// the regroup permutation, 128-lane frame tiles, rolls, and the super-block
// chunking with SMEM carries.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fladder_stages.cuh"
#include "persistent.cuh"

namespace {

using namespace fladder_stages;

constexpr double kEmph = 0.96875;   // 1 - 1/32

__device__ __forceinline__ double to_f64(int16_t v) { return static_cast<double>(v); }
__device__ __forceinline__ double to_f64(float v) { return static_cast<double>(v); }

// Blocks an SM must hold at once, which caps the registers: 64 a thread at
// nfft 256 (4 blocks), 85 at 512 (3; at 4 the compiler spills 152 bytes
// and the kernel runs ~8% slower), 128 at 1024 (2, all its shared memory
// allows).
template <int LOG2P>
constexpr int kResident = LOG2P == 4 ? 2 : LOG2P == 3 ? 3 : 4;

template <typename In, int LOG2P>
__global__ void __launch_bounds__(kThreads, kResident<LOG2P>)
fladder_kernel(const In* __restrict__ audio, float* __restrict__ out,
               long long T, int F, int hop, long long frames, int nfilters,
               int ncep, const double2* __restrict__ win,
               const double2* __restrict__ tw, const double* __restrict__ mel,
               const double* __restrict__ dct, const int2* __restrict__ band,
               double mel_floor) {
  extern __shared__ double2 smem[];
  constexpr int log2m = 5 + LOG2P;
  constexpr int kP = 1 << LOG2P;
  const Smem sm = carve(smem, log2m + 1);
  load_constants(sm, log2m + 1, tw, mel, band, nfilters);
  __syncthreads();

  // each warp takes frames G = s * F + g in a grid-stride loop
  const int l = lane();
  for (long long G = static_cast<long long>(blockIdx.x) * kFrames + threadIdx.x / kLanes;
       G < frames; G += static_cast<long long>(gridDim.x) * kFrames) {
    const long long s = G / F;
    const int g = static_cast<int>(G - s * F);
    const In* x = audio + s * T + static_cast<long long>(g) * hop;
    // ingest: pre-emphasis and window * 1/nfft on sample pairs, packed as
    // z[m] = y[2m] + i*y[2m+1], lane l's register r holding z[l + 32r]
    double2 z[kP];
#pragma unroll
    for (int r = 0; r < kP; ++r) {
      const int m = l + 32 * r;
      const double p = g > 0 || m > 0 ? to_f64(x[2 * m - 1]) : 0.0;
      const double a = to_f64(x[2 * m]);
      const double b = to_f64(x[2 * m + 1]);
      z[r] = window_pair(a - kEmph * p, b - kEmph * a, win[m]);
    }
    ladder_tail<LOG2P>(z, sm, nfilters, ncep, mel, dct, band, mel_floor,
                       out + G * ncep);
  }
}

template <typename In>
int launch(const In* audio, float* out, long long S, long long T, int F,
           int hop, int nfft, int nfilters, int ncep, const double* win,
           const double* tw, const double* mel, const double* dct,
           const int* band, double mel_floor, void* stream) {
  const int log2n = log2_nfft(nfft);
  if (log2n < 0 || F < 1 || hop < 1 || nfilters < 1 || nfilters > nfft / 2 ||
      ncep < 1 || S < 0 || T < static_cast<long long>(F - 1) * hop + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const long long frames = S * F;
  return with_points(nfft, [&](auto pts) {
    constexpr int L = decltype(pts)::value;
    return launch_persistent(
        fladder_kernel<In, L>, kThreads, (frames + kFrames - 1) / kFrames,
        smem_bytes(nfft), stream, audio, out, T, F, hop, frames, nfilters,
        ncep, reinterpret_cast<const double2*>(win),
        reinterpret_cast<const double2*>(tw), mel, dct,
        reinterpret_cast<const int2*>(band), mel_floor);
  });
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
