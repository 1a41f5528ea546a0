// K5 for Hopper (sm_90a): the split-DFT float MFCC, from raw audio and from
// frames, in one kernel each.
//
//  mfcc_radix2_{i16,f32}:  (S, T) int16 or f32 audio -> (S, F, ncep) f32.
//      Replaces the TPU kernel mfcc_tpu/ops/pallas_mfcc.py:
//      _mfcc_radix2_kernel (entry mfcc_pallas_radix2, the
//      precision="fast" batch route).
//  mfcc_frames_float_f32:  (M, nfft) f32 pre-emphasized frames -> (M, ncep)
//      f32.  Replaces pallas_mfcc.py:_mfcc_frames_float_kernel (entry
//      mfcc_pallas_frames_float, the fast frames route).
//
// Both are an ingest in front of the tail of radix2_stages.cuh (which the
// split-DFT serving step in stream_step.cu shares); see there for the
// function, the dft_passes forms and the precision argument.  The batch
// ingest frames by address, as K1 (fladder.cu): frame g, point p reads
// x[g*hop + p] and the sample before it (0 at t = 0), emphasizes in f32 as
// x - 0.96875f*p rounded twice (__fmul_rn / __fsub_rn, as the serving
// step: nvcc would contract it into an FMA), so int16 stays int16 on the
// wire and the emphasized value of an int16 sample is exact.  The frames
// ingest reads row g of the (M, nfft) frames.
//
// Design: one thread block of 256 threads per (stream, tile of FT frames),
// FT = 4096/nfft (8 at nfft 512); the tile's 2 FT half-frame signals are
// the product's right-hand side.  Offsets are 64-bit.
//
// What bounds it, per call at the headline size (S=1024 x T=63,922 int16,
// nfft 512, hop 170: 382,976 frames): ~131 MB in and ~49 MB out, ~54 us of
// HBM time; the DFT product's 2.0e11 (3 passes) or 1.0e11 (4 and 6) FP64
// operations, ~3.0 ms / ~1.5 ms at the card's 67 TFLOP/s of FP64 tensor
// cores, bound this design (measured 7.7 and 5.3 ms on an H100 80GB HBM3 at
// 700 W, PERF.md; an FP64 FMA loop took 17.6 and 11.8 ms).  The function's
// own least time is that of its limb products on the bf16 tensor cores
// (chip_smoke.py counts them).
//
// Not carried from the TPU kernels: the 256-row packed operator with the
// cos-bin-nfft/4 row parked last and its circular roll, melc, the
// positions-major (hop, bf) tiles and their transposes (R2_KERNEL_T), the
// NBMAX super-blocks with an SMEM carry scalar, and the module globals.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix2_stages.cuh"

namespace {

using namespace radix2_stages;

constexpr float kEmph = 0.96875f;   // 1 - 1/32

__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ float emph(float x, float p) {
  return __fsub_rn(x, __fmul_rn(kEmph, p));
}

template <typename In, int PASSES, int ST>
__global__ void __launch_bounds__(kThreads)
radix2_kernel(const In* __restrict__ audio, float* __restrict__ out,
              long long T, int F, int hop, int nfft, int nfilters, int ncep,
              int frames_per_block, long long tiles_per_stream,
              const float* __restrict__ cos_t, const float* __restrict__ sin_t,
              const float* __restrict__ we, const float* __restrict__ wo,
              const float2* __restrict__ tw, const float* __restrict__ mel,
              const float* __restrict__ dct, const int2* __restrict__ band,
              float mel_floor) {
  extern __shared__ double2 smem[];
  const int FT = frames_per_block;
  const Smem sm = carve(smem, FT, nfft, nfilters);
  const int nh = sm.nh;

  const long long s = blockIdx.x / tiles_per_stream;
  const int f0 = static_cast<int>(blockIdx.x % tiles_per_stream) * FT;
  const In* x = audio + s * T;

  load_constants<PASSES>(sm, cos_t, sin_t, tw, band, nfilters);
  for (int i = threadIdx.x; i < FT * nh; i += blockDim.x) {
    const int f = i >> sm.log2nh;
    const int m = i & (nh - 1);
    const int g = f0 + f;
    if (g < F) {
      const long long t = static_cast<long long>(g) * hop + 2 * m;
      const float p = t > 0 ? to_f32(x[t - 1]) : 0.0f;
      const float a = to_f32(x[t]);
      const float b = to_f32(x[t + 1]);
      put_pair<PASSES>(sm, f, m, emph(a, p), emph(b, a), we, wo);
    } else {
      put_zero(sm, f, m);
    }
  }
  __syncthreads();

  radix2_tail<PASSES, ST>(sm, FT, nfilters, ncep, mel, dct, mel_floor,
                          out + s * F * ncep, f0, F);
}

template <int PASSES, int ST>
__global__ void __launch_bounds__(kThreads)
frames_kernel(const float* __restrict__ frames, float* __restrict__ out,
              long long M, int nfft, int nfilters, int ncep,
              int frames_per_block, const float* __restrict__ cos_t,
              const float* __restrict__ sin_t, const float* __restrict__ we,
              const float* __restrict__ wo, const float2* __restrict__ tw,
              const float* __restrict__ mel, const float* __restrict__ dct,
              const int2* __restrict__ band, float mel_floor) {
  extern __shared__ double2 smem[];
  const int FT = frames_per_block;
  const Smem sm = carve(smem, FT, nfft, nfilters);
  const int nh = sm.nh;
  const long long g0 = static_cast<long long>(blockIdx.x) * FT;
  const int F = static_cast<int>(M - g0 < FT ? M - g0 : FT);

  load_constants<PASSES>(sm, cos_t, sin_t, tw, band, nfilters);
  for (int i = threadIdx.x; i < FT * nh; i += blockDim.x) {
    const int f = i >> sm.log2nh;
    const int m = i & (nh - 1);
    if (f < F) {
      const float2 y = reinterpret_cast<const float2*>(frames + (g0 + f) * nfft)[m];
      put_pair<PASSES>(sm, f, m, y.x, y.y, we, wo);
    } else {
      put_zero(sm, f, m);
    }
  }
  __syncthreads();

  radix2_tail<PASSES, ST>(sm, FT, nfilters, ncep, mel, dct, mel_floor,
                          out + g0 * ncep, 0, F);
}

template <typename In, int PASSES, int ST>
int launch_radix2(const In* audio, float* out, long long S, long long T, int F,
                  int hop, int nfft, int nfilters, int ncep, const Tables& tb,
                  float mel_floor, void* stream) {
  const int FT = frames_per_block(nfft);
  const long long tiles = (F + FT - 1) / FT;
  if (S * tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const size_t smem = smem_bytes(FT, nfft, nfilters);
  const int err = fladder_stages::allow_smem(radix2_kernel<In, PASSES, ST>, smem);
  if (err != 0) return err;
  radix2_kernel<In, PASSES, ST><<<static_cast<unsigned>(S * tiles), kThreads,
                                  smem, static_cast<cudaStream_t>(stream)>>>(
      audio, out, T, F, hop, nfft, nfilters, ncep, FT, tiles, tb.cos_t, tb.sin_t,
      tb.we, tb.wo, reinterpret_cast<const float2*>(tb.tw), tb.mel, tb.dct,
      reinterpret_cast<const int2*>(tb.band), mel_floor);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_audio(const In* audio, float* out, long long S, long long T, int F,
                 int hop, int nfft, int nfilters, int ncep, int passes,
                 const Tables& tb, double mel_floor, void* stream) {
  if (!geometry_ok(nfft, passes, nfilters, ncep) || F < 1 || hop < 1 ||
      hop % 2 || S < 0 || T < static_cast<long long>(F - 1) * hop + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  const float fl = static_cast<float>(mel_floor);
  return dispatch(passes, nfft, [&](auto p, auto st) {
    return launch_radix2<In, decltype(p)::value, decltype(st)::value>(
        audio, out, S, T, F, hop, nfft, nfilters, ncep, tb, fl, stream);
  });
}

template <int PASSES, int ST>
int launch_frames(const float* frames, float* out, long long M, int nfft,
                  int nfilters, int ncep, const Tables& tb, float mel_floor,
                  void* stream) {
  const int FT = frames_per_block(nfft);
  const long long blocks = (M + FT - 1) / FT;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const size_t smem = smem_bytes(FT, nfft, nfilters);
  const int err = fladder_stages::allow_smem(frames_kernel<PASSES, ST>, smem);
  if (err != 0) return err;
  frames_kernel<PASSES, ST><<<static_cast<unsigned>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      frames, out, M, nfft, nfilters, ncep, FT, tb.cos_t, tb.sin_t, tb.we,
      tb.wo, reinterpret_cast<const float2*>(tb.tw), tb.mel, tb.dct,
      reinterpret_cast<const int2*>(tb.band), mel_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  cos_t and sin_t hold nfft/2 float32
// entries cos(2 pi i/(nfft/2))/nfft and -sin(...)/nfft; we and wo the
// Hamming window at the even and odd positions (nfft/2 each); tw nfft/4
// float32 pairs (cos, sin)(2 pi j/nfft); mel (nfft/2 x nfilters) and dct
// (nfilters x ncep) float32, row-major; band nfilters int32 pairs [lo, hi)
// outside which a mel column is zero.  passes is 3, 4 or 6 and the hop is
// even (as the TPU kernel requires).  Launches on `stream`, on the calling
// thread's current device (the caller sets it), without synchronizing;
// returns a cudaError_t (0 = launched).
extern "C" int mfcc_radix2_i16(const int16_t* audio, float* out, long long S,
                               long long T, int F, int hop, int nfft,
                               int nfilters, int ncep, int passes,
                               const float* cos_t, const float* sin_t,
                               const float* we, const float* wo,
                               const float* tw, const float* mel,
                               const float* dct, const int* band,
                               double mel_floor, void* stream) {
  const Tables tb{cos_t, sin_t, we, wo, tw, mel, dct, band};
  return launch_audio(audio, out, S, T, F, hop, nfft, nfilters, ncep, passes,
                      tb, mel_floor, stream);
}

extern "C" int mfcc_radix2_f32(const float* audio, float* out, long long S,
                               long long T, int F, int hop, int nfft,
                               int nfilters, int ncep, int passes,
                               const float* cos_t, const float* sin_t,
                               const float* we, const float* wo,
                               const float* tw, const float* mel,
                               const float* dct, const int* band,
                               double mel_floor, void* stream) {
  const Tables tb{cos_t, sin_t, we, wo, tw, mel, dct, band};
  return launch_audio(audio, out, S, T, F, hop, nfft, nfilters, ncep, passes,
                      tb, mel_floor, stream);
}

// frames: (M, nfft) float32, contiguous.
extern "C" int mfcc_frames_float_f32(const float* frames, float* out,
                                     long long M, int nfft, int nfilters,
                                     int ncep, int passes, const float* cos_t,
                                     const float* sin_t, const float* we,
                                     const float* wo, const float* tw,
                                     const float* mel, const float* dct,
                                     const int* band, double mel_floor,
                                     void* stream) {
  if (!geometry_ok(nfft, passes, nfilters, ncep) || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables tb{cos_t, sin_t, we, wo, tw, mel, dct, band};
  const float fl = static_cast<float>(mel_floor);
  return dispatch(passes, nfft, [&](auto p, auto st) {
    return launch_frames<decltype(p)::value, decltype(st)::value>(
        frames, out, M, nfft, nfilters, ncep, tb, fl, stream);
  });
}
