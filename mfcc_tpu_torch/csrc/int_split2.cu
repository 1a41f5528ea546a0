// K10 for Hopper (sm_90a): K2's bit-exact INT MFCC in two launches, cut at
// the power spectrum.
//
//  mfcc_int_front_i16:  (S, T) int16 audio -> (S*F, 256) int32 power rows
//      in natural bin order: wrap16 pre-emphasis, framing, the LUT window,
//      the 512-point INT FFT and the power (uint32)(r*r + i*i) >> 2, a
//      logical shift.  Replaces tools/ab_int_r5.py:front_kernel (the first
//      pallas_call of split2_build).
//  mfcc_int_epi:  (M, 256) int32 power rows -> (M, ncep) int32 cepstra:
//      the integer filterbank mod 2^64, Turner log2 and the INT DCT.
//      Replaces tools/ab_int_r5.py:epi_kernel (the second pallas_call).
//
// Both run the device functions of int_stages.cuh that K2 runs (ingest,
// ladder_power, then post_power), in the same order on the same values, so
// the pair is element-exact with K2 and with the RTL oracle
// ref/int_ref.mfcc_int.  The TPU arm wrote (N, nbins, L) lane-major power
// blocks; here a power row is one frame's 256 bins, as the next launch
// reads them.
//
// Design: one thread block of 256 threads per tile of 8 frames in each
// launch, one warp per frame, as K2: the front loads its frame as K2 does
// and stores lane l's power of bins l + 32k straight from its registers
// (coalesced), the epilogue loads a frame's row the same way into the
// warp's shared row.  What bounds it:
// K2's int32 operations (the front the ladder and power, the epilogue the
// filterbank, log2 and DCT) plus the power buffer's write and read, 2 x 1
// KB per frame (0.78 GB at the headline's 382,976 frames, ~0.23 ms at 3.35
// TB/s).  The split exists to measure what the fused kernel saves by
// keeping the power on chip.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int_stages.cuh"

namespace {

using namespace int_stages;

__global__ void __launch_bounds__(kThreads)
int_front_kernel(const int16_t* __restrict__ audio, int* __restrict__ power,
                 long long T, int F, int hop, long long tiles_per_stream,
                 const int* __restrict__ curve, const int2* __restrict__ tw) {
  __shared__ Smem sm;
  const long long s = blockIdx.x / tiles_per_stream;
  const int f = static_cast<int>(threadIdx.x) / kLanes;
  const int g = static_cast<int>(blockIdx.x % tiles_per_stream) * kFrames + f;
  load_ladder_tables(sm, tw);
  __syncthreads();
  if (g >= F) return;
  int re[kPts], pw[kBinsPerLane];
  load_audio_frame(audio + s * T + static_cast<long long>(g) * hop, g == 0,
                   curve, re);
  ladder_power(re, sm.row + f * kRow, sm.stw, pw);
  int* p = power + (s * F + g) * kNbins + lane();
#pragma unroll
  for (int k = 0; k < kBinsPerLane; ++k) p[32 * k] = pw[k];
}

__global__ void __launch_bounds__(kThreads)
int_epi_kernel(const int* __restrict__ power, int* __restrict__ out,
               long long M, Tail c) {
  __shared__ Smem sm;
  const int f = static_cast<int>(threadIdx.x) / kLanes;
  const long long m = static_cast<long long>(blockIdx.x) * kFrames + f;
  load_tail_tables(sm, c);
  __syncthreads();
  if (m >= M) return;
  int* row = sm.row + f * kRow;
  const int* p = power + m * kNbins + lane();
#pragma unroll
  for (int k = 0; k < kBinsPerLane; ++k) row[lane() + 32 * k] = p[32 * k];
  __syncwarp();
  post_power(row, sm, c, out + m * c.ncep);
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer; the tables are those of int_mfcc.cu's
// entry points.  power is (S*F, 256) int32, row (s*F + g) the power of
// stream s's frame g; out is (M, ncep) int32.  Launches on `stream`, on the
// calling thread's current device (the caller sets it), without
// synchronizing; returns a cudaError_t (0 = launched).
extern "C" int mfcc_int_front_i16(const int16_t* audio, int* power,
                                  long long S, long long T, int F, int hop,
                                  const int* curve, const int* tw,
                                  void* stream) {
  if (F < 1 || hop < 1 || S < 0 ||
      T < static_cast<long long>(F - 1) * hop + kNfft)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const long long tiles = (F + kFrames - 1) / kFrames;
  const long long blocks = S * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int_front_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      audio, power, T, F, hop, tiles, curve,
      reinterpret_cast<const int2*>(tw));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mfcc_int_epi(const int* power, int* out, long long M,
                            int nfilters, int ncep, int fb_shift,
                            int log_precision, int log_width, const int* dtw,
                            const long long* fbw, const int* band,
                            void* stream) {
  const Tail c = make_tail(fbw, band, dtw, nfilters, ncep, fb_shift,
                           log_precision, log_width);
  if (!tail_ok(c) || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const long long blocks = (M + kFrames - 1) / kFrames;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int_epi_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(power, out, M, c);
  return static_cast<int>(cudaGetLastError());
}
