// K7 for Hopper (sm_90a): the f64ish float MFCC, from raw audio and from
// frames, in one kernel each, in FP64.
//
//  mfcc_f64ish_{i16,f32}:  (S, T) int16 or f32 audio -> (S, F, ncep) f32.
//  mfcc_f64ish_frames_f32: (M, nfft) f32 pre-emphasized frames -> (M, ncep)
//      f32.
//
// Replaces the TPU kernel mfcc_tpu/ops/pallas_df32.py:_f64ish_kernel
// (entries mfcc_f64ish_pallas and mfcc_f64ish_pallas_frames): the same
// function, not its block structure.  Per frame:
//   pre-emphasis y = x - 0.96875f*prev in f32 (batch entry only) ->
//   optionally the 2^-5 wire grid, rint(y*32)/32 in FP64 -> window * 1/nfft
//   -> FFT -> |X|^2 on bins [0, nfft/2) -> mel -> log2 -> DCT,
// everything after the grid step in FP64 on K1's tail (fladder_stages.cuh),
// rounded to f32 once at the store.  The TPU kernel reaches the 1e-5 gate
// without FP64: 8-bit balanced limbs of the grid integers on the MXU,
// TwoSum-compensated f32 accumulation, split mel/DCT operators and a LUT
// log2 in double-f32.  None of that is needed on a card with FP64; FP64
// FMAs and log2 take its place.
//
// Rounding, each step on purpose:
//  * emphasis in f32, rounded twice (__fmul_rn / __fsub_rn): nvcc would
//    contract it into an FMA, and the JAX chain rounds twice.  For int16
//    samples the f32 result is exact (<= 21 significant bits), so on int16
//    input this kernel computes K1's values bit for bit;
//  * the grid step rounds half to even (rint, as jnp.round in the JAX
//    chain df32.py).  The JAX kernel truncates x*32 instead
//    (pallas_df32.py:272), which differs off the grid; the pipeline's route
//    is the chain.  Neither C round (half away from zero) nor truncation is
//    used.  The step is exact for finite f32 input (x*32 and /32 are
//    power-of-two scalings), so unlike the JAX chain's int32 cast it never
//    wraps; wire_grid is defined for int16-range samples either way.
//  * mel_floor is 0: the f64ish mode has none (digital silence gives -inf /
//    NaN, as in the JAX package).
//
// Design: K1's tail (fladder_stages.cuh) in K1's persistent grid
// (persistent.cuh, fladder.cu): as many blocks of 8 warps as the card
// holds at once, each loading its twiddles and mel schedule to shared memory
// once; each warp then takes frames in a grid-stride loop, one frame at a
// time, loading its frame's packed points straight into registers.  The
// batch entry walks the flat frames G = s*F + g and frames by address into
// the int16 or f32 input (frame g, point p reads x[g*hop + p] and the
// sample before it, 0 at t = 0); the frames entry walks the rows.  Offsets
// are 64-bit.  A block per 8 frames of a stream would load the tables
// 48,128 times at the headline and idle 2 warps of every stream's last
// tile (374 = 46 x 8 + 6).
//
// What bounds it, at the headline size (S=1024 x T=63,922 int16, nfft 512,
// hop 170: 382,976 frames): K1's ~19.6 kFLOP of FP64 per frame plus the
// grid step, ~7.9 GFLOP, 0.23 ms at 34 TFLOP/s (HBM 0.054 ms); the frames
// entry reads 784 MB of f32 frames, 0.25 ms at 3.35 TB/s.  chip_smoke.py
// counts both from this source.  K1's tail, which both entries run, is
// bound by instruction issue (fladder.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fladder_stages.cuh"
#include "persistent.cuh"

namespace {

using namespace fladder_stages;

constexpr float kEmph = 0.96875f;   // 1 - 1/32

__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ float emph(float x, float p) {
  return __fsub_rn(x, __fmul_rn(kEmph, p));
}

// An emphasized f32 sample in FP64, on the 2^-5 grid (half to even) when
// wire_grid.
__device__ __forceinline__ double grid(float y, int wire_grid) {
  const double v = static_cast<double>(y);
  return wire_grid ? rint(v * 32.0) * 0.03125 : v;
}

// Blocks an SM must hold at once, which caps the registers, as K1's
// (fladder.cu): 4 at nfft 256, 3 at 512, 2 at 1024 (all its shared memory
// allows).  nvcc -Xptxas=-v gives both kernels 64 / 80 / 128 registers
// there, for either input, and no spills (chip_smoke.py prints the
// report).  At 2 blocks at nfft 512 (118 registers) K7 runs ~5% slower.
template <int LOG2P>
constexpr int kResident = LOG2P == 4 ? 2 : LOG2P == 3 ? 3 : 4;

template <typename In, int LOG2P>
__global__ void __launch_bounds__(kThreads, kResident<LOG2P>)
f64ish_kernel(const In* __restrict__ audio, float* __restrict__ out,
              long long T, int F, int hop, long long frames, int nfilters,
              int ncep, const double2* __restrict__ win,
              const double2* __restrict__ tw, const double* __restrict__ mel,
              const double* __restrict__ dct, const int2* __restrict__ band,
              const double2* __restrict__ msched, int msteps, int wire_grid) {
  extern __shared__ double2 smem[];
  constexpr int log2m = 5 + LOG2P;
  constexpr int kP = 1 << LOG2P;
  const Smem sm = carve(smem, log2m + 1, msteps);
  load_constants(sm, log2m + 1, tw, mel, band, msched, nfilters);
  __syncthreads();

  // each warp takes frames G = s * F + g in a grid-stride loop
  const int l = lane();
  for (long long G = static_cast<long long>(blockIdx.x) * kFrames + threadIdx.x / kLanes;
       G < frames; G += static_cast<long long>(gridDim.x) * kFrames) {
    const long long s = G / F;
    const int g = static_cast<int>(G - s * F);
    const In* x = audio + s * T + static_cast<long long>(g) * hop;
    // sample pairs, packed as z[m] = y[2m] + i*y[2m+1], lane l's register
    // r holding z[l + 32r]
    double2 z[kP];
#pragma unroll
    for (int r = 0; r < kP; ++r) {
      const int m = l + 32 * r;
      const float p = g > 0 || m > 0 ? to_f32(x[2 * m - 1]) : 0.0f;
      const float a = to_f32(x[2 * m]);
      const float b = to_f32(x[2 * m + 1]);
      z[r] = window_pair(grid(emph(a, p), wire_grid),
                         grid(emph(b, a), wire_grid), win[m]);
    }
    ladder_tail<LOG2P>(z, sm, nfilters, ncep, mel, dct, band, 0.0,
                       out + G * ncep);
  }
}

template <int LOG2P>
__global__ void __launch_bounds__(kThreads, kResident<LOG2P>)
f64ish_frames_kernel(const float* __restrict__ frames, float* __restrict__ out,
                     long long M_frames, int nfilters, int ncep,
                     const double2* __restrict__ win,
                     const double2* __restrict__ tw,
                     const double* __restrict__ mel,
                     const double* __restrict__ dct,
                     const int2* __restrict__ band,
                     const double2* __restrict__ msched, int msteps,
                     int wire_grid) {
  extern __shared__ double2 smem[];
  constexpr int log2m = 5 + LOG2P;
  constexpr int nfft = 2 << log2m;
  constexpr int kP = 1 << LOG2P;
  const Smem sm = carve(smem, log2m + 1, msteps);
  load_constants(sm, log2m + 1, tw, mel, band, msched, nfilters);
  __syncthreads();

  // each warp takes rows G in a grid-stride loop
  const int l = lane();
  for (long long G = static_cast<long long>(blockIdx.x) * kFrames + threadIdx.x / kLanes;
       G < M_frames; G += static_cast<long long>(gridDim.x) * kFrames) {
    const float* row = frames + G * nfft;
    double2 z[kP];
#pragma unroll
    for (int r = 0; r < kP; ++r) {
      const int m = l + 32 * r;
      z[r] = window_pair(grid(row[2 * m], wire_grid),
                         grid(row[2 * m + 1], wire_grid), win[m]);
    }
    ladder_tail<LOG2P>(z, sm, nfilters, ncep, mel, dct, band, 0.0,
                       out + G * ncep);
  }
}

// The checks of both entries; true if the arguments are out of range.
inline bool bad_tables(int nfft, int nfilters, int ncep) {
  return log2_nfft(nfft) < 0 || nfilters < 1 || nfilters > nfft / 2 ||
         ncep < 1;
}

template <typename In>
int launch_audio(const In* audio, float* out, long long S, long long T, int F,
                 int hop, int nfft, int nfilters, int ncep, const double* win,
                 const double* tw, const double* mel, const double* dct,
                 const int* band, const void* msched, int msteps,
                 int wire_grid, void* stream) {
  if (bad_tables(nfft, nfilters, ncep) || F < 1 || hop < 1 || S < 0 ||
      T < static_cast<long long>(F - 1) * hop + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const long long frames = S * F;
  return with_points(nfft, [&](auto pts) {
    constexpr int L = decltype(pts)::value;
    return launch_persistent(
        f64ish_kernel<In, L>, kThreads, (frames + kFrames - 1) / kFrames,
        smem_bytes(nfft), stream, audio, out, T, F, hop, frames, nfilters,
        ncep, reinterpret_cast<const double2*>(win),
        reinterpret_cast<const double2*>(tw), mel, dct,
        reinterpret_cast<const int2*>(band),
        static_cast<const double2*>(msched), mel_steps(msched, msteps, nfft),
        wire_grid);
  });
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  win (nfft, the window * 1/nfft), mel
// (nfft/2 x nfilters, the Nyquist row dropped) and dct (nfilters x ncep)
// are float64, row-major; tw holds nfft/2 interleaved complex float64
// twiddles exp(-2*pi*i*k/nfft); band holds nfilters int32 pairs [lo, hi)
// outside which a mel column is zero; msched and msteps are the mel
// schedule (or null and 0), as fladder.cu's entries take them; wire_grid
// is 0 or 1.  Launches on
// `stream`, on the calling thread's current device (the caller sets it),
// without synchronizing; returns a cudaError_t (0 = launched).
extern "C" int mfcc_f64ish_i16(const int16_t* audio, float* out, long long S,
                               long long T, int F, int hop, int nfft,
                               int nfilters, int ncep, const double* win,
                               const double* tw, const double* mel,
                               const double* dct, const int* band,
                               const void* msched, int msteps,
                               int wire_grid, void* stream) {
  return launch_audio(audio, out, S, T, F, hop, nfft, nfilters, ncep, win, tw,
                      mel, dct, band, msched, msteps, wire_grid, stream);
}

extern "C" int mfcc_f64ish_f32(const float* audio, float* out, long long S,
                               long long T, int F, int hop, int nfft,
                               int nfilters, int ncep, const double* win,
                               const double* tw, const double* mel,
                               const double* dct, const int* band,
                               const void* msched, int msteps,
                               int wire_grid, void* stream) {
  return launch_audio(audio, out, S, T, F, hop, nfft, nfilters, ncep, win, tw,
                      mel, dct, band, msched, msteps, wire_grid, stream);
}

// frames: (M, nfft) float32, contiguous.
extern "C" int mfcc_f64ish_frames_f32(const float* frames, float* out,
                                      long long M, int nfft, int nfilters,
                                      int ncep, const double* win,
                                      const double* tw, const double* mel,
                                      const double* dct, const int* band,
                                      const void* msched, int msteps,
                                      int wire_grid, void* stream) {
  if (bad_tables(nfft, nfilters, ncep) || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  return with_points(nfft, [&](auto pts) {
    constexpr int L = decltype(pts)::value;
    return launch_persistent(
        f64ish_frames_kernel<L>, kThreads, (M + kFrames - 1) / kFrames,
        smem_bytes(nfft), stream, frames, out, M, nfilters, ncep,
        reinterpret_cast<const double2*>(win),
        reinterpret_cast<const double2*>(tw), mel, dct,
        reinterpret_cast<const int2*>(band),
        static_cast<const double2*>(msched), mel_steps(msched, msteps, nfft),
        wire_grid);
  });
}
