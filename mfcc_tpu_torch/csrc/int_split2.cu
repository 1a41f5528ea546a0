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
// ladder_power; then post_power_balanced: the filterbank on the balanced
// schedule, log2 and DCT), on the same values, so the pair is
// element-exact with K2 and with the RTL oracle
// ref/int_ref.mfcc_int.  The TPU arm wrote (N, nbins, L) lane-major power
// blocks; here a power row is one frame's 256 bins, as the next launch
// reads them.
//
// Design: one warp per frame, as K2.  The front runs a block of 256
// threads per tile of 8 frames, loads its frame as K2 does and stores lane
// l's power of bins l + 32k straight from its registers (coalesced).  The
// epilogue is persistent (persistent.cuh): a block loads the balanced
// filterbank's schedule and the DCT twiddles into shared memory once (5 KB;
// it used to build a 12 KB banded weight table, a division and a gather
// per entry, for every 8 frames: ~590 MB of table traffic at the headline),
// then each warp walks rows in a grid-stride loop, loading a row as two
// 16-byte words a lane into its shared row and the next row's into
// registers while the current one runs post_power_balanced.  What bounds
// it: the epilogue reads 1 KB of power and writes 128 B a frame (~0.13 ms
// at the headline's 382,976 frames at 3.35 TB/s) for ~9k int32 operations
// of filterbank, log2 and DCT (~0.1 ms at the issue limit); the front the
// ladder's int32 operations (~0.56 ms) beside its 1 KB write.  The split
// exists to measure what the fused kernel saves by keeping the power on
// chip.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int_stages.cuh"
#include "persistent.cuh"

namespace {

using namespace int_stages;

// The epilogue's blocks an SM: at 4 nvcc -Xptxas=-v reports 47 registers
// and no spill; 6 (40 registers) read no faster and 8 (32, spilling) 10%
// slower in an A/B of the residencies (tools/step_ab.py).
constexpr int kEpiResident = 4;
constexpr int kRowWords = kNbins / 4;    // a power row's 16-byte words
static_assert(kRow % 4 == 0, "the warps' rows start on 16-byte boundaries");

__global__ void __launch_bounds__(kThreads)
int_front_kernel(const int16_t* __restrict__ audio, int* __restrict__ power,
                 long long T, int F, int hop, long long tiles_per_stream,
                 const int* __restrict__ curve, const int2* __restrict__ tw) {
  __shared__ FbLadderSmem sm;   // its rows and twiddles
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

// Lane l's two 16-byte words of power row m: words l and l + 32.
__device__ __forceinline__ void load_row(const int4* power, long long m,
                                         int4 (&v)[2]) {
  v[0] = power[m * kRowWords + lane()];
  v[1] = power[m * kRowWords + kLanes + lane()];
}

__global__ void __launch_bounds__(kThreads, kEpiResident)
int_epi_kernel(const int4* __restrict__ power, int* __restrict__ out,
               long long M, const uint2* __restrict__ sched, Tail c) {
  __shared__ FbSmem sm;
  load_fb_tables(sm.fb, sched, c);
  __syncthreads();
  int* row = sm.row + (threadIdx.x / kLanes) * kRow;
  int4* row4 = reinterpret_cast<int4*>(row);
  const long long step = static_cast<long long>(gridDim.x) * kFrames;
  long long m = static_cast<long long>(blockIdx.x) * kFrames + threadIdx.x / kLanes;
  int4 v[2];
  if (m < M) load_row(power, m, v);
  for (; m < M; m += step) {
    row4[lane()] = v[0];
    row4[kLanes + lane()] = v[1];
    __syncwarp();
    if (m + step < M) load_row(power, m + step, v);   // in flight meanwhile
    post_power_balanced(row, sm.fb, c, out + m * c.ncep);
    __syncwarp();
  }
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer; the tables are those of int_mfcc.cu's
// entry points (sched the balanced filterbank's schedule, as
// mfcc_int_frames_i32 takes it).  power is (S*F, 256) int32, row (s*F + g)
// the power of stream s's frame g, 16-byte aligned; out is (M, ncep)
// int32.  Launches on `stream`, on the
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
                            const int* sched, void* stream) {
  const Tail c = make_tail(dtw, nfilters, ncep, fb_shift, log_precision,
                           log_width);
  if (!tail_ok(c) || M < 0 || reinterpret_cast<uintptr_t>(power) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  return launch_persistent(int_epi_kernel, kThreads,
                           (M + kFrames - 1) / kFrames, 0, stream,
                           reinterpret_cast<const int4*>(power), out, M,
                           reinterpret_cast<const uint2*>(sched), c);
}
