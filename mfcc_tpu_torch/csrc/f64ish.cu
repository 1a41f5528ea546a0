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
// Design: K1's (fladder.cu): one block of 256 threads per (stream, tile of
// 1024/(nfft/2) frames) or per tile of frames; the batch ingest frames by
// address into the int16 or f32 input (frame g, point p reads x[g*hop + p]
// and the sample before it, 0 at t = 0), the frames ingest reads row g.
// Offsets are 64-bit.
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

template <typename In>
__global__ void __launch_bounds__(kThreads)
f64ish_kernel(const In* __restrict__ audio, float* __restrict__ out,
              long long T, int F, int hop, int log2n, int nfilters, int ncep,
              int frames_per_block, long long tiles_per_stream,
              const double* __restrict__ win, const double2* __restrict__ tw,
              const double* __restrict__ mel, const double* __restrict__ dct,
              const int2* __restrict__ band, int wire_grid) {
  extern __shared__ double2 smem[];
  const int FT = frames_per_block;
  const int log2m = log2n - 1;
  const int M = 1 << log2m;
  const Smem sm = carve(smem, FT, log2n, nfilters);

  const long long s = blockIdx.x / tiles_per_stream;
  const int f0 = static_cast<int>(blockIdx.x % tiles_per_stream) * FT;
  const In* x = audio + s * T;

  load_constants(sm, tw, band, M, nfilters);

  // ingest on sample pairs, packed as z[m] = y[2m] + i*y[2m+1]
  for (int i = threadIdx.x; i < FT * M; i += blockDim.x) {
    const int f = i >> log2m;
    const int m = i & (M - 1);
    const int g = f0 + f;
    double2 z = make_double2(0.0, 0.0);
    if (g < F) {
      const long long t = static_cast<long long>(g) * hop + 2 * m;
      const float p = t > 0 ? to_f32(x[t - 1]) : 0.0f;
      const float a = to_f32(x[t]);
      const float b = to_f32(x[t + 1]);
      z = make_double2(grid(emph(a, p), wire_grid) * win[2 * m],
                       grid(emph(b, a), wire_grid) * win[2 * m + 1]);
    }
    sm.buf[f * sm.R + pad(m)] = z;
  }
  __syncthreads();

  ladder_tail(sm, FT, log2n, nfilters, ncep, mel, dct, 0.0, out + s * F * ncep,
              f0, F);
}

__global__ void __launch_bounds__(kThreads)
f64ish_frames_kernel(const float* __restrict__ frames, float* __restrict__ out,
                     long long M_frames, int log2n, int nfilters, int ncep,
                     int frames_per_block, const double* __restrict__ win,
                     const double2* __restrict__ tw,
                     const double* __restrict__ mel,
                     const double* __restrict__ dct,
                     const int2* __restrict__ band, int wire_grid) {
  extern __shared__ double2 smem[];
  const int FT = frames_per_block;
  const int log2m = log2n - 1;
  const int M = 1 << log2m;
  const int nfft = 2 * M;
  const Smem sm = carve(smem, FT, log2n, nfilters);
  const long long g0 = static_cast<long long>(blockIdx.x) * FT;
  const int F = static_cast<int>(M_frames - g0 < FT ? M_frames - g0 : FT);

  load_constants(sm, tw, band, M, nfilters);

  for (int i = threadIdx.x; i < FT * M; i += blockDim.x) {
    const int f = i >> log2m;
    const int m = i & (M - 1);
    double2 z = make_double2(0.0, 0.0);
    if (f < F) {
      const float* row = frames + (g0 + f) * nfft;
      z = make_double2(grid(row[2 * m], wire_grid) * win[2 * m],
                       grid(row[2 * m + 1], wire_grid) * win[2 * m + 1]);
    }
    sm.buf[f * sm.R + pad(m)] = z;
  }
  __syncthreads();

  ladder_tail(sm, FT, log2n, nfilters, ncep, mel, dct, 0.0, out + g0 * ncep, 0,
              F);
}

template <typename In>
int launch_audio(const In* audio, float* out, long long S, long long T, int F,
                 int hop, int nfft, int nfilters, int ncep, const double* win,
                 const double* tw, const double* mel, const double* dct,
                 const int* band, int wire_grid, void* stream) {
  const int log2n = log2_nfft(nfft);
  if (log2n < 0 || F < 1 || hop < 1 || nfilters < 1 || ncep < 1 || S < 0 ||
      T < static_cast<long long>(F - 1) * hop + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const int FT = frames_per_block(nfft);
  const long long tiles = (F + FT - 1) / FT;
  const long long blocks = S * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(FT, nfft, nfilters);
  const int err = allow_smem(f64ish_kernel<In>, smem);
  if (err != 0) return err;
  f64ish_kernel<In><<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      audio, out, T, F, hop, log2n, nfilters, ncep, FT, tiles, win,
      reinterpret_cast<const double2*>(tw), mel, dct,
      reinterpret_cast<const int2*>(band), wire_grid);
  return static_cast<int>(cudaGetLastError());
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
  const int log2n = log2_nfft(nfft);
  if (log2n < 0 || nfilters < 1 || ncep < 1 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const int FT = frames_per_block(nfft);
  const long long blocks = (M + FT - 1) / FT;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(FT, nfft, nfilters);
  const int err = allow_smem(f64ish_frames_kernel, smem);
  if (err != 0) return err;
  f64ish_frames_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      frames, out, M, log2n, nfilters, ncep, FT, win,
      reinterpret_cast<const double2*>(tw), mel, dct,
      reinterpret_cast<const int2*>(band), wire_grid);
  return static_cast<int>(cudaGetLastError());
}
