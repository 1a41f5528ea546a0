// Fused bit-exact INT MFCC for Hopper (sm_90a): three entries on two
// kernels, one of them behind two ingests.
//
//  K2, mfcc_int_i16:  (S, T) int16 audio -> (S, F, ncep) int32 cepstra.
//      Replaces the TPU kernel mfcc_tpu/ops/pallas_int.py:_int_kernel_v3
//      (entry mfcc_int_pallas_v3).  Per frame: wrap16 pre-emphasis,
//      framing, the LUT Hamming window, then the tail below.
//  K3-v1, mfcc_int_i32:  (S, T) int32 audio -> (S, F, ncep) int32: K2's
//      kernel with the samples read whole, the pre-emphasis x + (prev >>
//      5) - prev taken mod 2^32 before its wrap16 (preemph32).  Replaces
//      pallas_int.py:_int_kernel behind mfcc_int_pallas, whose emphasis
//      and framing run in XLA before the kernel (pallas_int.py:1271-1272);
//      here both are the ingest's arithmetic and addressing, and no frames
//      tensor exists.  On int16 samples the two rules are one function.
//  K3, mfcc_int_frames_i32:  (M, 512) int32 pre-emphasized frames ->
//      (M, ncep) int32.  Replaces pallas_int.py:_int_kernel (entry
//      mfcc_int_pallas_frames, which windows in XLA before the kernel;
//      here the window runs in the kernel: the same function).
//  Tail (int_stages.cuh tail_balanced, every entry's): 512-point bit-exact
//  radix-2 DIT (3-multiply butterfly, bias round, >> 14, >> 1, wrap16),
//  power mod 2^32 >> 2, the integer mel filterbank mod 2^64 on the
//  balanced schedule keeping bits [shift, shift+16), Turner log2 (Q4.11),
//  DCT-II via a 4*nfilters-point INT FFT.  Every output is element-exact
//  with the RTL oracle ref/int_ref.mfcc_int.
//
// Design (int_stages.cuh): a persistent grid (persistent.cuh) of blocks of
// 8 warps; a block loads its twiddles, the window curve and the balanced
// filterbank's schedule into shared memory once, then each warp takes frames in a
// grid-stride loop, one frame at a time.  K2's and K3-v1's warp reads
// its frame's 512 samples and the one before its start (0 at t = 0)
// straight from the input -- overlapped framing is addressing, and no
// pre-emphasis carry crosses frames -- and K3's its frame row, each lane
// loading the windowed samples of the ladder's first layout into
// registers (lane l's register r holds sample bitrev(16l + r): 32
// consecutive samples across the lanes).  From
// there the warp runs its frame alone: the 512-point ladder in registers,
// 16 points a lane, two exchanges through its shared row under
// __syncwarp; the power in registers; the filterbank as 16 scheduled terms
// a lane (the bank's ~430 nonzero terms cut into 32 runs of 14), then a
// lane per filter sums its segments' slots and takes log2; the DCT
// ladder's nonzero half in registers and shuffles; lane c stores cepstrum
// c.  No barrier after the tables', and what is provably zero is skipped
// (the first stage's imaginary inputs, the DCT's lower half, stage 8's
// bins >= 256); one butterfly per thread per stage through shared memory,
// with a barrier each (18 a tile of 8 frames), takes ~3.9 ms.
// The TPU kernels' structure is not carried: their sigma/evenodd8 row
// order and _regroup_perm, (8, lanes) sublane blocks, pltpu.roll
// reversals, 128-lane frame tiles, NBMAX_INT super-blocks with an SMEM
// pre-emphasis carry, host-side transposes, and the 8-bit-limb bf16 MXU
// filterbank with base-2^23 digit carries (Hopper has native 64-bit
// integer multiply-add).
//
// What bounds it, at the headline size (S=1024 x T=63,922, hop 170:
// 382,976 frames): ~131 MB of int16 in (K3-v1: ~262 MB of int32) and ~49
// MB of int32 out, ~0.054 ms (K3-v1 0.093) at 3.35 TB/s; ~55k int32
// operations per frame that the function needs (chip_smoke.py counts them
// from the ladders' structure: at most 21 per butterfly, fewer where
// inputs are zero or outputs unused; the 9-stage ladder 46k with zero
// imaginary inputs and the bins no filter reads; the 128-point DCT ladder
// 4k, 3/4 of its inputs zero and 32 real outputs kept; window, power,
// filterbank and log2 5k), ~2.1e10 per call, ~0.64 ms at the issue limit
// of 128 lanes per clock per SM (132 SMs, 1.98 GHz).  Instruction issue
// bounds it, not memory (tools/sass_mix.py; 42% IMAD, the moves, adds and
// shifts the compiler maps onto the FMA pipe): with their 16 scheduled
// filterbank terms a lane inline, K2's walk is 2,489 SASS instructions a
// frame and K3's 2,337, where the function needs ~1.7k a lane; K2 at
// 1.12 ms issues ~3.3 warp instructions a clock per SM of the 4 its
// schedulers can (at 1.98 GHz).
//
// Offsets are 64-bit: S*T passes 2^31 at S=4096 x 60 s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int_stages.cuh"
#include "persistent.cuh"

namespace {

using namespace int_stages;

// Both kernels are persistent (persistent.cuh): a block loads its tables
// once, then each warp takes frames G in a grid-stride loop, loading the
// frame's windowed samples straight into the ladder's first layout.  The
// launch bounds set the blocks an SM (without them the compiler pipelines
// the loop at 124-173 registers, one block fits, and the kernel runs ~40%
// slower).  K3 takes 3 blocks: its window curve is read from shared memory
// through a volatile pointer, which spills nothing there.
constexpr int kFramesResident = 3;

// K2 (int16) and K3-v1 (int32) take 4 blocks an SM: nvcc -Xptxas=-v
// reports 64 registers and 8 bytes spilled for each, and both run 0.8-1.0%
// faster than at 3 (80 registers, no spill); the curve from global memory
// spills 72 bytes at 4.
constexpr int kAudioResident = 4;

// In: int16_t (K2) or int32_t (K3-v1), the ingest's sample type.
template <typename In>
__global__ void __launch_bounds__(kThreads, kAudioResident)
int_audio_kernel(const In* __restrict__ audio, int* __restrict__ out,
                 long long T, int F, int hop, long long frames,
                 const int* __restrict__ curve, const int2* __restrict__ tw,
                 const uint2* __restrict__ sched, Tail c) {
  __shared__ FbLadderSmem sm;
  load_ladder_tables(sm, tw);
  load_fb_tables(sm.fb, sched, c);
  for (int i = threadIdx.x; i < kNfft; i += blockDim.x) sm.curve[i] = curve[i];
  __syncthreads();
  const volatile int* cv = sm.curve;   // read each frame, as in K3
  for (long long G = static_cast<long long>(blockIdx.x) * kFrames + threadIdx.x / kLanes;
       G < frames; G += static_cast<long long>(gridDim.x) * kFrames) {
    const long long s = G / F;
    const int g = static_cast<int>(G - s * F);
    int re[kPts];
    load_audio_frame(audio + s * T + static_cast<long long>(g) * hop, g == 0,
                     cv, re);
    tail_balanced(re, sm, c, out + G * c.ncep);
  }
}

__global__ void __launch_bounds__(kThreads, kFramesResident)
int_frames_kernel(const int* __restrict__ frames, int* __restrict__ out,
                  long long M, const int* __restrict__ curve,
                  const int2* __restrict__ tw,
                  const uint2* __restrict__ sched, Tail c) {
  __shared__ FbLadderSmem sm;
  load_ladder_tables(sm, tw);
  load_fb_tables(sm.fb, sched, c);
  for (int i = threadIdx.x; i < kNfft; i += blockDim.x) sm.curve[i] = curve[i];
  __syncthreads();
  // The curve is read each frame, through a volatile pointer: kept in
  // registers across the walk, a lane's 16 curve values spilled at 3
  // blocks an SM.
  const volatile int* cv = sm.curve;
  for (long long m = static_cast<long long>(blockIdx.x) * kFrames + threadIdx.x / kLanes;
       m < M; m += static_cast<long long>(gridDim.x) * kFrames) {
    // first_sample(r) = bitrev(lane, 5) + 32 * rev4(r): one base a lane
    // and constant offsets, the loads of first_sample's own addresses
    const int b = bitrev(lane(), 5);
    const int* x = frames + m * kNfft + b;
    int re[kPts];
#pragma unroll
    for (int r = 0; r < kPts; ++r) {
      const int q = 32 * rev4(r);
      re[r] = window(x[q], cv[b + q]);
    }
    tail_balanced(re, sm, c, out + m * c.ncep);
  }
}

template <typename In>
int launch_audio(const In* audio, int* out, long long S, long long T, int F,
                 int hop, int nfilters, int ncep, int fb_shift,
                 int log_precision, int log_width, const int* curve,
                 const int* tw, const int* dtw, const int* sched,
                 void* stream) {
  const Tail c = make_tail(dtw, nfilters, ncep, fb_shift, log_precision,
                           log_width);
  if (!tail_ok(c) || F < 1 || hop < 1 || S < 0 ||
      T < static_cast<long long>(F - 1) * hop + kNfft)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const long long frames = S * F;
  return launch_persistent(int_audio_kernel<In>, kThreads,
                           (frames + kFrames - 1) / kFrames, 0, stream, audio,
                           out, T, F, hop, frames, curve,
                           reinterpret_cast<const int2*>(tw),
                           reinterpret_cast<const uint2*>(sched), c);
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  curve holds the 512 int32 window
// values (tables.int_window_curve(512, 8)); tw the 256 interleaved int32
// (re, im) twiddles of tables.twiddle_table(512, 16) and dtw the 2*nfilters
// of twiddle_table(4*nfilters, 16); sched the balanced filterbank's schedule
// (int_stages.cuh, ops/int_fused.py fb_schedule: kFbSteps * 32 uint2
// entries, then 32 uint32 gather words).  audio is (S, T) and contiguous;
// out is (S, F, ncep), resp. (M, ncep), int32.  Launches on `stream`, on the
// calling thread's current device (the caller sets it), without
// synchronizing; returns a cudaError_t (0 = launched).
extern "C" int mfcc_int_i16(const int16_t* audio, int* out, long long S,
                            long long T, int F, int hop, int nfilters,
                            int ncep, int fb_shift, int log_precision,
                            int log_width, const int* curve, const int* tw,
                            const int* dtw, const int* sched, void* stream) {
  return launch_audio(audio, out, S, T, F, hop, nfilters, ncep, fb_shift,
                      log_precision, log_width, curve, tw, dtw, sched,
                      stream);
}

// K3-v1: mfcc_int_i16's arguments, with (S, T) int32 audio read whole.
extern "C" int mfcc_int_i32(const int* audio, int* out, long long S,
                            long long T, int F, int hop, int nfilters,
                            int ncep, int fb_shift, int log_precision,
                            int log_width, const int* curve, const int* tw,
                            const int* dtw, const int* sched, void* stream) {
  return launch_audio(audio, out, S, T, F, hop, nfilters, ncep, fb_shift,
                      log_precision, log_width, curve, tw, dtw, sched,
                      stream);
}

extern "C" int mfcc_int_frames_i32(const int* frames, int* out, long long M,
                                   int nfilters, int ncep, int fb_shift,
                                   int log_precision, int log_width,
                                   const int* curve, const int* tw,
                                   const int* dtw, const int* sched,
                                   void* stream) {
  const Tail c = make_tail(dtw, nfilters, ncep, fb_shift, log_precision,
                           log_width);
  if (!tail_ok(c) || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  return launch_persistent(int_frames_kernel, kThreads,
                           (M + kFrames - 1) / kFrames, 0, stream, frames, out,
                           M, curve, reinterpret_cast<const int2*>(tw),
                           reinterpret_cast<const uint2*>(sched), c);
}
