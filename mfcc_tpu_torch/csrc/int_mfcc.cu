// Fused bit-exact INT MFCC for Hopper (sm_90a), two kernels on one body:
//
//  K2, mfcc_int_i16:  (S, T) int16 audio -> (S, F, ncep) int32 cepstra.
//      Replaces the TPU kernel mfcc_tpu/ops/pallas_int.py:_int_kernel_v3
//      (entry mfcc_int_pallas_v3).  Per frame: wrap16 pre-emphasis,
//      framing, the LUT Hamming window, then the tail below.
//  K3, mfcc_int_frames_i32:  (M, 512) int32 pre-emphasized frames ->
//      (M, ncep) int32.  Replaces pallas_int.py:_int_kernel (entry
//      mfcc_int_pallas_frames, which windows in XLA before the kernel;
//      here the window runs in the kernel: the same function).
//  Tail (int_stages.cuh): 512-point bit-exact radix-2 DIT (3-multiply
//  butterfly, bias round, >> 14, >> 1, wrap16), power mod 2^32 >> 2, the
//  integer mel filterbank mod 2^64 keeping bits [shift, shift+16), Turner
//  log2 (Q4.11), DCT-II via a 4*nfilters-point INT FFT.  Every output is
//  element-exact with the RTL oracle ref/int_ref.mfcc_int.
//
// Design, one thread block of 256 threads per tile of 8 frames (K2: per
// (stream, tile)):
//  * each frame reads its 512 samples and the one before its start (0 at
//    t = 0) straight from the input: overlapped framing is addressing, and
//    no pre-emphasis carry crosses blocks; the load stores each windowed
//    sample at its bit-reversed position;
//  * the FFTs run in shared memory, int32 re/im rows, one barrier a stage;
//  * the filterbank sums each filter's nonzero band only (limits from the
//    wrapper; each bin feeds at most two filters), in uint64.
// The TPU kernels' structure is not carried: their sigma/evenodd8 row
// order and _regroup_perm, (8, lanes) sublane blocks, pltpu.roll
// reversals, 128-lane frame tiles, NBMAX_INT super-blocks with an SMEM
// pre-emphasis carry, host-side transposes, and the 8-bit-limb bf16 MXU
// filterbank with base-2^23 digit carries (Hopper has native 64-bit
// integer multiply-add).
//
// What bounds it, at the headline size (S=1024 x T=63,922, hop 170:
// 382,976 frames): ~131 MB of int16 in and ~49 MB of int32 out, ~0.054 ms
// at 3.35 TB/s; ~55k int32 operations per frame that the function needs
// (chip_smoke.py counts them from the ladders' structure: at most 21 per
// butterfly, fewer where inputs are zero or outputs unused; the 9-stage
// ladder 46k with zero imaginary inputs and the bins no filter reads; the
// 128-point DCT ladder 4k, 3/4 of its inputs zero and 32 real outputs
// kept; window, power, filterbank and log2 5k), ~2.1e10 per call,
// ~0.64 ms at the issue limit of 128 lanes per clock per SM (132 SMs,
// 1.98 GHz).  Integer issue bounds it, not memory.  This first kernel
// spends issue slots on what a later one would cut: one butterfly per
// thread per stage with shared-memory round trips and a barrier per stage
// (18 barriers per tile), 2-way bank conflicts in the first two stages,
// and every butterfly computed in full, the zero ones of the first stage
// and of the DCT included.
//
// Offsets are 64-bit: S*T passes 2^31 at S=4096 x 60 s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int_stages.cuh"

namespace {

using namespace int_stages;

__global__ void __launch_bounds__(kThreads)
int_audio_kernel(const int16_t* __restrict__ audio, int* __restrict__ out,
                 long long T, int F, int hop, long long tiles_per_stream,
                 const int* __restrict__ curve, const int2* __restrict__ tw,
                 Tail c) {
  __shared__ Smem sm;
  const long long s = blockIdx.x / tiles_per_stream;
  const int f0 = static_cast<int>(blockIdx.x % tiles_per_stream) * kFrames;
  const int16_t* x = audio + s * T;
  load_twiddles(sm, tw, c);
  for (int b = threadIdx.x; b < kFrames * kNfft; b += blockDim.x) {
    const int f = b >> kLog2Nfft;
    const int p = b & (kNfft - 1);
    const int g = f0 + f;
    int v = 0;
    if (g < F) {
      const long long t = static_cast<long long>(g) * hop + p;
      const int prev = t > 0 ? x[t - 1] : 0;
      v = window(preemph(x[t], prev), curve[p]);
    }
    store_point(sm, f, p, v);
  }
  run_tail(sm, c);
  for (int o = threadIdx.x; o < kFrames * c.ncep; o += blockDim.x) {
    const int f = o / c.ncep;
    const int k = o - f * c.ncep;
    const int g = f0 + f;
    if (g < F) out[(s * F + g) * c.ncep + k] = sm.re[f * kRow + pad(k)];
  }
}

__global__ void __launch_bounds__(kThreads)
int_frames_kernel(const int* __restrict__ frames, int* __restrict__ out,
                  long long M, const int* __restrict__ curve,
                  const int2* __restrict__ tw, Tail c) {
  __shared__ Smem sm;
  const long long m0 = static_cast<long long>(blockIdx.x) * kFrames;
  load_twiddles(sm, tw, c);
  for (int b = threadIdx.x; b < kFrames * kNfft; b += blockDim.x) {
    const int f = b >> kLog2Nfft;
    const int p = b & (kNfft - 1);
    const long long m = m0 + f;
    store_point(sm, f, p, m < M ? window(frames[m * kNfft + p], curve[p]) : 0);
  }
  run_tail(sm, c);
  for (int o = threadIdx.x; o < kFrames * c.ncep; o += blockDim.x) {
    const int f = o / c.ncep;
    const int k = o - f * c.ncep;
    const long long m = m0 + f;
    if (m < M) out[m * c.ncep + k] = sm.re[f * kRow + pad(k)];
  }
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  curve holds the 512 int32 window
// values (tables.int_window_curve(512, 8)); tw the 256 interleaved int32
// (re, im) twiddles of tables.twiddle_table(512, 16) and dtw the 2*nfilters
// of twiddle_table(4*nfilters, 16); fbw the (256, nfilters) int64
// filterbank matrix, row-major; band nfilters int32 pairs [lo, hi) outside
// which a column of fbw is zero.  out is (S, F, ncep), resp. (M, ncep),
// int32.  Launches on `stream`, on the calling thread's current device
// (the caller sets it), without synchronizing; returns a cudaError_t
// (0 = launched).
extern "C" int mfcc_int_i16(const int16_t* audio, int* out, long long S,
                            long long T, int F, int hop, int nfilters,
                            int ncep, int fb_shift, int log_precision,
                            int log_width, const int* curve, const int* tw,
                            const int* dtw, const long long* fbw,
                            const int* band, void* stream) {
  const Tail c = make_tail(fbw, band, dtw, nfilters, ncep, fb_shift,
                           log_precision, log_width);
  if (!tail_ok(c) || F < 1 || hop < 1 || S < 0 ||
      T < static_cast<long long>(F - 1) * hop + kNfft)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const long long tiles = (F + kFrames - 1) / kFrames;
  const long long blocks = S * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int_audio_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      audio, out, T, F, hop, tiles, curve,
      reinterpret_cast<const int2*>(tw), c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mfcc_int_frames_i32(const int* frames, int* out, long long M,
                                   int nfilters, int ncep, int fb_shift,
                                   int log_precision, int log_width,
                                   const int* curve, const int* tw,
                                   const int* dtw, const long long* fbw,
                                   const int* band, void* stream) {
  const Tail c = make_tail(fbw, band, dtw, nfilters, ncep, fb_shift,
                           log_precision, log_width);
  if (!tail_ok(c) || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const long long blocks = (M + kFrames - 1) / kFrames;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int_frames_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      frames, out, M, curve, reinterpret_cast<const int2*>(tw), c);
  return static_cast<int>(cudaGetLastError());
}
