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
// Design: K1's tail (fladder_stages.cuh): one block of 8 warps per
// (stream, tile of 8 frames) or per tile of 8 frames, one warp per frame,
// each warp loading its frame's packed points straight into registers; the
// batch entry frames by address into the int16 or f32 input (frame g,
// point p reads x[g*hop + p] and the sample before it, 0 at t = 0), the
// frames entry reads row g.  Offsets are 64-bit.
//
// What bounds it, at the headline size (S=1024 x T=63,922 int16, nfft 512,
// hop 170: 382,976 frames): K1's ~19.6 kFLOP of FP64 per frame plus the
// grid step, ~7.9 GFLOP, 0.23 ms at 34 TFLOP/s (HBM 0.054 ms); the frames
// entry reads 784 MB of f32 frames, 0.25 ms at 3.35 TB/s.  chip_smoke.py
// counts both from this source.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fladder_stages.cuh"

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

template <typename In, int LOG2P>
__global__ void __launch_bounds__(kThreads)
f64ish_kernel(const In* __restrict__ audio, float* __restrict__ out,
              long long T, int F, int hop, int nfilters, int ncep,
              long long tiles_per_stream, const double2* __restrict__ win,
              const double2* __restrict__ tw, const double* __restrict__ mel,
              const double* __restrict__ dct, const int2* __restrict__ band,
              int wire_grid) {
  extern __shared__ double2 smem[];
  constexpr int log2m = 5 + LOG2P;
  const Smem sm = carve(smem, log2m + 1);
  load_constants(sm, log2m + 1, tw, mel, band, nfilters);
  __syncthreads();

  const long long s = blockIdx.x / tiles_per_stream;
  const int g = static_cast<int>(blockIdx.x % tiles_per_stream) * kFrames +
                static_cast<int>(threadIdx.x) / kLanes;
  if (g >= F) return;
  const In* x = audio + s * T + static_cast<long long>(g) * hop;
  // sample pairs, packed as z[m] = y[2m] + i*y[2m+1], lane l's register r
  // holding z[l + 32r]
  double2 z[1 << LOG2P];
#pragma unroll
  for (int r = 0; r < (1 << LOG2P); ++r) {
    const int m = lane() + 32 * r;
    const float p = g > 0 || m > 0 ? to_f32(x[2 * m - 1]) : 0.0f;
    const float a = to_f32(x[2 * m]);
    const float b = to_f32(x[2 * m + 1]);
    z[r] = window_pair(grid(emph(a, p), wire_grid), grid(emph(b, a), wire_grid),
                       win[m]);
  }
  ladder_tail<LOG2P>(z, sm, nfilters, ncep, mel, dct, band, 0.0,
                     out + (s * F + g) * ncep);
}

template <int LOG2P>
__global__ void __launch_bounds__(kThreads)
f64ish_frames_kernel(const float* __restrict__ frames, float* __restrict__ out,
                     long long M_frames, int nfilters, int ncep,
                     const double2* __restrict__ win,
                     const double2* __restrict__ tw,
                     const double* __restrict__ mel,
                     const double* __restrict__ dct,
                     const int2* __restrict__ band, int wire_grid) {
  extern __shared__ double2 smem[];
  constexpr int log2m = 5 + LOG2P;
  constexpr int nfft = 2 << log2m;
  const Smem sm = carve(smem, log2m + 1);
  load_constants(sm, log2m + 1, tw, mel, band, nfilters);
  __syncthreads();

  const long long g = static_cast<long long>(blockIdx.x) * kFrames +
                      threadIdx.x / kLanes;
  if (g >= M_frames) return;
  const float* row = frames + g * nfft;
  double2 z[1 << LOG2P];
#pragma unroll
  for (int r = 0; r < (1 << LOG2P); ++r) {
    const int m = lane() + 32 * r;
    z[r] = window_pair(grid(row[2 * m], wire_grid),
                       grid(row[2 * m + 1], wire_grid), win[m]);
  }
  ladder_tail<LOG2P>(z, sm, nfilters, ncep, mel, dct, band, 0.0,
                     out + g * ncep);
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
                 const int* band, int wire_grid, void* stream) {
  if (bad_tables(nfft, nfilters, ncep) || F < 1 || hop < 1 || S < 0 ||
      T < static_cast<long long>(F - 1) * hop + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const long long tiles = (F + kFrames - 1) / kFrames;
  const long long blocks = S * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(nfft);
  return with_points(nfft, [&](auto pts) {
    constexpr int L = decltype(pts)::value;
    const int err = allow_smem(f64ish_kernel<In, L>, smem);
    if (err != 0) return err;
    f64ish_kernel<In, L><<<static_cast<unsigned>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        audio, out, T, F, hop, nfilters, ncep, tiles,
        reinterpret_cast<const double2*>(win),
        reinterpret_cast<const double2*>(tw), mel, dct,
        reinterpret_cast<const int2*>(band), wire_grid);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  win (nfft, the window * 1/nfft), mel
// (nfft/2 x nfilters, the Nyquist row dropped) and dct (nfilters x ncep)
// are float64, row-major; tw holds nfft/2 interleaved complex float64
// twiddles exp(-2*pi*i*k/nfft); band holds nfilters int32 pairs [lo, hi)
// outside which a mel column is zero; wire_grid is 0 or 1.  Launches on
// `stream`, on the calling thread's current device (the caller sets it),
// without synchronizing; returns a cudaError_t (0 = launched).
extern "C" int mfcc_f64ish_i16(const int16_t* audio, float* out, long long S,
                               long long T, int F, int hop, int nfft,
                               int nfilters, int ncep, const double* win,
                               const double* tw, const double* mel,
                               const double* dct, const int* band,
                               int wire_grid, void* stream) {
  return launch_audio(audio, out, S, T, F, hop, nfft, nfilters, ncep, win, tw,
                      mel, dct, band, wire_grid, stream);
}

extern "C" int mfcc_f64ish_f32(const float* audio, float* out, long long S,
                               long long T, int F, int hop, int nfft,
                               int nfilters, int ncep, const double* win,
                               const double* tw, const double* mel,
                               const double* dct, const int* band,
                               int wire_grid, void* stream) {
  return launch_audio(audio, out, S, T, F, hop, nfft, nfilters, ncep, win, tw,
                      mel, dct, band, wire_grid, stream);
}

// frames: (M, nfft) float32, contiguous.
extern "C" int mfcc_f64ish_frames_f32(const float* frames, float* out,
                                      long long M, int nfft, int nfilters,
                                      int ncep, const double* win,
                                      const double* tw, const double* mel,
                                      const double* dct, const int* band,
                                      int wire_grid, void* stream) {
  if (bad_tables(nfft, nfilters, ncep) || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const long long blocks = (M + kFrames - 1) / kFrames;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(nfft);
  return with_points(nfft, [&](auto pts) {
    constexpr int L = decltype(pts)::value;
    const int err = allow_smem(f64ish_frames_kernel<L>, smem);
    if (err != 0) return err;
    f64ish_frames_kernel<L><<<static_cast<unsigned>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        frames, out, M, nfilters, ncep, reinterpret_cast<const double2*>(win),
        reinterpret_cast<const double2*>(tw), mel, dct,
        reinterpret_cast<const int2*>(band), wire_grid);
    return static_cast<int>(cudaGetLastError());
  });
}
