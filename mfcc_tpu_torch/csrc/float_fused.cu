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
// Both are an ingest in front of the tail of radix2_stages.cuh, whose
// product runs on the engine of dmma_product.cuh (which the split-DFT
// serving step in stream_step.cu shares); see there for the function, the
// dft_passes forms, the lo*lo correction's error bound and the budget.
// The batch ingest frames by address, as K1 (fladder.cu): frame g, point p
// reads x[g*hop + p] and the sample before it (0 at t = 0), emphasizes in
// f32 as x - 0.96875f*p rounded twice (__fmul_rn / __fsub_rn, as the
// serving step: nvcc would contract it into an FMA), so int16 stays int16
// on the wire and the emphasized value of an int16 sample is exact.  The
// frames ingest reads row g of the (M, nfft) frames.
//
// Design: a persistent grid of blocks of 8 warps, one an SM; a tile is FT
// = 16384/nfft consecutive frames (32 at nfft 512) of the flattened (S x
// F) frame list, so no stream's ragged end wastes a tile.  Offsets are
// 64-bit.
//
// What bounds it, per call at the headline size (S=1024 x T=63,922 int16,
// nfft 512, hop 170: 382,976 frames): ~131 MB in and ~49 MB out, ~54 us of
// HBM time; the DFT product's 1.0e11 FP64 operations (the (hi+lo)(hi+lo)
// or f32 product), 1.5 ms at the card's 67 TFLOP/s of FP64 tensor cores,
// bound this design, plus at 3 passes the lo*lo correction's 5e10 bf16
// operations (~0.05 ms at 989 TFLOP/s).  The function's own least time is
// that of its limb products on the bf16 tensor cores (chip_smoke.py counts
// them).  The operator's L2 reads: 384 KB (3 passes; 256 KB at 4 and 6)
// per 32-frame tile.

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
constexpr int kU = 8;               // ingest sample pairs in flight a thread

__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ float emph(float x, float p) {
  return __fsub_rn(x, __fmul_rn(kEmph, p));
}

template <typename In, int PASSES, int CT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
radix2_kernel(Geometry geo, long long M, const OpT* __restrict__ op,
              const In* __restrict__ audio, float* __restrict__ out,
              long long T, int F, int hop, int nfilters, int ncep, Tables tb,
              float mel_floor) {
  extern __shared__ __align__(16) unsigned char r2_smem[];
  run<PASSES, CT, NT>(r2_smem, geo, M, op, tb, nfilters, ncep, mel_floor, out,
                      [&](const Smem& sm, long long G0) {
    const int nh = sm.nh, n = sm.FT * nh;
    frame_table(sm, G0, M, F);
    // kU sample pairs a thread in flight: their loads first, then the stores
    for (int i0 = threadIdx.x; i0 < n; i0 += kU * kConsumers) {
      float p[kU], a[kU], b[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kConsumers;
        p[u] = a[u] = b[u] = 0.0f;
        const int2 sg = i < n ? sm.fr[i >> sm.log2nh] : make_int2(-1, 0);
        if (sg.x >= 0) {
          const In* x = audio + sg.x * T;
          const long long t = static_cast<long long>(sg.y) * hop + 2 * (i & (nh - 1));
          p[u] = t > 0 ? to_f32(x[t - 1]) : 0.0f;
          a[u] = to_f32(x[t]);
          b[u] = to_f32(x[t + 1]);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kConsumers;
        if (i >= n) break;
        const int f = i >> sm.log2nh, m = i & (nh - 1);
        if (sm.fr[f].x >= 0)
          put_pair<PASSES>(sm, f, m, emph(a[u], p[u]), emph(b[u], a[u]), tb.we, tb.wo);
        else
          put_zero<PASSES>(sm, f, m);
      }
    }
    consumer_sync();
  }, [&](const Smem& sm, long long G0) {
    // thread f: the samples of the tile's frame f
    const long long G = G0 + threadIdx.x;
    if (threadIdx.x < sm.FT && G < M) {
      const long long t = (G % F) * hop;
      const In* x = audio + (G / F) * T + (t > 0 ? t - 1 : 0);
      prefetch_l2(x, sizeof(In) * (geo.nfft + 1), 0, 1);
    }
  });
}

template <int PASSES, int CT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
frames_kernel(Geometry geo, long long M, const OpT* __restrict__ op,
              const float* __restrict__ frames, float* __restrict__ out,
              int nfilters, int ncep, Tables tb, float mel_floor) {
  extern __shared__ __align__(16) unsigned char r2_smem[];
  run<PASSES, CT, NT>(r2_smem, geo, M, op, tb, nfilters, ncep, mel_floor, out,
                      [&](const Smem& sm, long long G0) {
    const int nh = sm.nh, n = sm.FT * nh;
    for (int i0 = threadIdx.x; i0 < n; i0 += kU * kConsumers) {
      float2 y[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kConsumers;
        const long long G = G0 + (i >> sm.log2nh);
        y[u] = i < n && G < M
                   ? reinterpret_cast<const float2*>(frames + G * geo.nfft)[i & (nh - 1)]
                   : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kConsumers;
        if (i >= n) break;
        const int f = i >> sm.log2nh, m = i & (nh - 1);
        if (G0 + f < M)
          put_pair<PASSES>(sm, f, m, y[u].x, y[u].y, tb.we, tb.wo);
        else
          put_zero<PASSES>(sm, f, m);
      }
    }
    consumer_sync();
  }, [&](const Smem& sm, long long G0) {
    const long long n = M - G0 < sm.FT ? M - G0 : sm.FT;
    prefetch_l2(frames + G0 * geo.nfft, sizeof(float) * n * geo.nfft,
                threadIdx.x, kThreads);
  });
}

template <typename In>
int launch_audio(const In* audio, float* out, long long S, long long T, int F,
                 int hop, int nfft, int nfilters, int ncep, int passes,
                 const Operator& o, const Tables& tb, double mel_floor,
                 void* stream) {
  if (!geometry_ok(nfft, passes, nfilters, ncep) || F < 1 || hop < 1 ||
      hop % 2 || S < 0 || T < static_cast<long long>(F - 1) * hop + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  const float fl = static_cast<float>(mel_floor);
  return dispatch(passes, nfft, [&](auto p, auto ct, auto nt) {
    return launch_r2(radix2_kernel<In, decltype(p)::value, decltype(ct)::value,
                                   decltype(nt)::value>,
                     S * F, nfft, nfilters, ncep, passes, o, tb, stream, audio,
                     out, T, F, hop, nfilters, ncep, tb, fl);
  });
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  (op, op_rows, chunk_rows) is the
// engine's operator (dmma_product.cuh,
// ops/dmma_product.py): the nh x nh split-DFT operator (nh = nfft/2, rows
// [0, nfft/4] cos(2 pi j m/nh)/nfft, then -sin rows j = 1 .. nfft/4 - 1) in
// fragment order, at 3 passes its bf16 lo limbs first, then hi + lo (3, 4)
// or the f32 values (6).  we and wo hold the Hamming window at the even
// and odd positions (nfft/2 each); tw nfft/4 float32 pairs (cos,
// sin)(2 pi j/nfft); band nfilters int32 pairs [lo, hi) outside which a
// column of the (nfft/2 x nfilters) mel matrix is zero, melw its mel_len
// band weights (filter m's mel[lo .. hi - 1, m] from melw[moff[m]]) and
// dct the (nfilters x ncep) float32 DCT, row-major.  passes is 3, 4 or 6 and the hop is even (as the TPU
// kernel requires).  Launches on `stream`, on the calling thread's current
// device (the caller sets it), without synchronizing; returns a
// cudaError_t (0 = launched).
extern "C" int mfcc_radix2_i16(const int16_t* audio, float* out, long long S,
                               long long T, int F, int hop, int nfft,
                               int nfilters, int ncep, int passes,
                               const void* op, int op_rows, int chunk_rows,
                               const float* we, const float* wo,
                               const float* tw, const float* melw,
                               const int* moff, const float* dct,
                               const int* band, int mel_len,
                               double mel_floor, void* stream) {
  const Operator o{op, op_rows, chunk_rows};
  const Tables tb{we, wo, tw, melw, moff, dct, band, mel_len};
  return launch_audio(audio, out, S, T, F, hop, nfft, nfilters, ncep, passes,
                      o, tb, mel_floor, stream);
}

extern "C" int mfcc_radix2_f32(const float* audio, float* out, long long S,
                               long long T, int F, int hop, int nfft,
                               int nfilters, int ncep, int passes,
                               const void* op, int op_rows, int chunk_rows,
                               const float* we, const float* wo,
                               const float* tw, const float* melw,
                               const int* moff, const float* dct,
                               const int* band, int mel_len,
                               double mel_floor, void* stream) {
  const Operator o{op, op_rows, chunk_rows};
  const Tables tb{we, wo, tw, melw, moff, dct, band, mel_len};
  return launch_audio(audio, out, S, T, F, hop, nfft, nfilters, ncep, passes,
                      o, tb, mel_floor, stream);
}

// frames: (M, nfft) float32, contiguous.
extern "C" int mfcc_frames_float_f32(const float* frames, float* out,
                                     long long M, int nfft, int nfilters,
                                     int ncep, int passes, const void* op,
                                     int op_rows, int chunk_rows,
                                     const float* we, const float* wo,
                                     const float* tw, const float* melw,
                                     const int* moff, const float* dct,
                                     const int* band, int mel_len,
                                     double mel_floor, void* stream) {
  if (!geometry_ok(nfft, passes, nfilters, ncep) || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operator o{op, op_rows, chunk_rows};
  const Tables tb{we, wo, tw, melw, moff, dct, band, mel_len};
  const float fl = static_cast<float>(mel_floor);
  return dispatch(passes, nfft, [&](auto p, auto ct, auto nt) {
    return launch_r2(frames_kernel<decltype(p)::value, decltype(ct)::value,
                                   decltype(nt)::value>,
                     M, nfft, nfilters, ncep, passes, o, tb, stream, frames,
                     out, nfilters, ncep, tb, fl);
  });
}

// The dynamic shared memory and ring stages of a split-DFT launch (K5,
// K5-frames, K4-split) with these arguments (0 and 0 where it would be
// refused).
extern "C" int mfcc_radix2_smem(int nfft, int nfilters, int ncep,
                                int mel_len, int passes, const void* op,
                                int op_rows, int chunk_rows, long long* smem,
                                int* stages) {
  const Operator o{op, op_rows, chunk_rows};
  Geometry geo;
  const bool ok = geometry_ok(nfft, passes, nfilters, ncep) &&
                  geometry(geo, nfft, nfilters, ncep, mel_len, passes, o);
  *smem = ok ? static_cast<long long>(geo.smem) : 0;
  *stages = ok ? geo.stages : 0;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
