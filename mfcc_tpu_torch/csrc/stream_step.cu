// The serving step K4 for Hopper (sm_90a): one chunk of every stream in,
// its completed frames' cepstra and the new carry out, in one kernel.  Three
// kernels, float, split-DFT float and bit-exact INT:
//
//  mfcc_stream_f32_{i16,f32}:  carry (S, P) f32, chunk (S, C) int16 or f32
//      -> (S, F, ncep) f32 + new carry (S, P) f32.  Replaces the TPU kernel
//      mfcc_tpu/ops/pallas_stream.py:_stream_fladder_kernel (entry
//      stream_step_float); the tail is K1's (fladder_stages.cuh).
//  mfcc_stream_r2_{i16,f32}:  the same operands and new carry, with K5's
//      split-DFT tail (radix2_stages.cuh) at dft_passes 3, 4 or 6.
//      Replaces pallas_stream.py:_stream_float_kernel (stream_step_float
//      where use_ladder is false: the precision="fast" serving step).  Its
//      ingest and new carry are K4-float's, so the carry is the same
//      tensor, and a streamed int16 frame reaches the tail with the f32
//      values K5's batch ingest gives it: the same operations.
//  mfcc_stream_int_{i16,i32}:  carry (S, P) int32, chunk (S, C) int16 or
//      int32 -> (S, F, ncep) int32 + new carry (S, P) int32.  Replaces
//      pallas_stream.py:_stream_int_kernel (entry stream_step_int); the
//      tail is K2's (int_stages.cuh), element-exact.
//
// The function, per stream s (P = nfft - 1, F = (C - 1) / hop + 1;
// start[s] = P - count and prev[s] with the reset already merged by the
// caller):
//   E[q] = carry[s, q]                                   for q < P,
//          emph(chunk[s, q-P], q == P ? prev[s] : chunk[s, q-P-1])
//                                                        for P <= q < P+C,
//          0                                              beyond (the zero
//          pad of streaming._chunk_step_batch);
//   frame f, point j = E[start[s] + f*hop + j] for f < F, then the batch
//   tail; the new carry is E[C : C+P].
// Frame slots past a stream's valid count are computed from the zero-padded
// signal like the others (the caller masks them), so kernel and plain
// version agree on every slot.
//
// Emphasis.  Float: x - 0.96875f * p in f32, rounded twice (__fmul_rn /
// __fsub_rn: nvcc would contract it into an FMA, which changes the carry of
// f32 input that is not integer-valued), then the value goes to FP64 for
// the tail.  For int16-valued input the f32 value is exact, so a streamed
// frame is K1's frame, operation for operation.  INT: wrap16(x + (p >> 5)
// - p) mod 2^32 on int32 (preemph32): int32 chunks are taken as they are,
// not mod 2^16 (the TPU step casts them to int32).
//
// Design, one thread block per (stream, tile of frames), as in K1 and K2:
// framing is addressing into the carry and the chunk, each point reading its
// sample and the one before it through L1; the carry and the chunk are read
// in place through a stream stride and a position stride, so the (S, P) and
// (P, S) carries and the (S, C) and (C, S) chunks need no relayout pass
// (the (C, S) chunk is read with a stride of S per point, uncoalesced).  The
// new carry is a separate output (the other tiles of the stream still read
// the old one), written by each stream's first tile.  Offsets are 64-bit:
// S*C passes 2^31 at S=4096 x C=2^19.  Float and INT tiles are K1's and
// K2's, 8 frames, one warp each: F = 7 at C = 1024 takes one tile, one warp
// idle.
//
// What bounds it at the serving shape (S=4096 x C=1024 int16, hop 170: 7
// frame slots, ~6 valid per stream): ~8.4 MB of chunk, ~16.7 MB of carry in
// and out, ~3.7 MB of features, ~9 us of HBM time; the tails' operations
// (chip_smoke.py counts them per valid frame) bound it: ~14 us of FP64 for
// the float step, ~41 us of int32 issue for the INT step; the split-DFT
// step's limb products bound it at the bf16 tensor-core rate, and its
// FP64 product loop bounds this design (see radix2_stages.cuh).
//
// Not carried from the TPU kernels: the [carry | chunk] scratch concat, the
// barrel-shifter alignment (_barrel_sublane), the even/odd and sigma frame
// rebuilds, the (X, bs) 128-lane stream blocks and their narrow-lane
// fallback.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fladder_stages.cuh"
#include "int_stages.cuh"
#include "radix2_stages.cuh"

namespace {

// Element strides of the per-stream operands.
struct Strides {
  long long carry_s, carry_p;     // old carry: stream, position
  long long chunk_s, chunk_t;     // chunk: stream, time
  long long ncarry_s, ncarry_p;   // new carry: stream, position
};

constexpr float kEmphF = 0.96875f;   // 1 - 1/32
constexpr int kU = 8;                // split-DFT ingest pairs in flight a thread

__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// E[q] of the float step for one stream (cs, xs: its carry and chunk).
template <typename In>
__device__ __forceinline__ float emph_f32(const float* cs, const In* xs,
                                          float pv, long long q, int P, int C,
                                          const Strides& st) {
  if (q < 0) return 0.0f;
  if (q < P) return cs[q * st.carry_p];
  const long long t = q - P;
  if (t >= C) return 0.0f;
  const float x = to_f32(xs[t * st.chunk_t]);
  const float p = t == 0 ? pv : to_f32(xs[(t - 1) * st.chunk_t]);
  return __fsub_rn(x, __fmul_rn(kEmphF, p));
}

// E[q] of the INT step.
template <typename In>
__device__ __forceinline__ int emph_int(const int* cs, const In* xs, int pv,
                                        long long q, int P, int C,
                                        const Strides& st) {
  if (q < 0) return 0;
  if (q < P) return cs[q * st.carry_p];
  const long long t = q - P;
  if (t >= C) return 0;
  const int x = static_cast<int>(xs[t * st.chunk_t]);
  const int p = t == 0 ? pv : static_cast<int>(xs[(t - 1) * st.chunk_t]);
  return int_stages::preemph32(x, p);
}

template <typename In, int LOG2P>
__global__ void __launch_bounds__(fladder_stages::kThreads)
stream_f32_kernel(const float* __restrict__ carry, const In* __restrict__ chunk,
                  const int* __restrict__ start, const float* __restrict__ prev,
                  float* __restrict__ out, float* __restrict__ ncarry, int P,
                  int C, int F, int hop, int nfilters, int ncep,
                  int tiles_per_stream, Strides st,
                  const double2* __restrict__ win, const double2* __restrict__ tw,
                  const double* __restrict__ mel, const double* __restrict__ dct,
                  const int2* __restrict__ band, double mel_floor) {
  using namespace fladder_stages;
  extern __shared__ double2 smem[];
  constexpr int log2m = 5 + LOG2P;
  const Smem sm = carve(smem, log2m + 1);

  const long long s = blockIdx.x / tiles_per_stream;
  const int tile = static_cast<int>(blockIdx.x % tiles_per_stream);
  const int f0 = tile * kFrames;
  const float* cs = carry + s * st.carry_s;
  const In* xs = chunk + s * st.chunk_s;
  const int s0 = start[s];
  const float pv = prev[s];

  load_constants(sm, log2m + 1, tw, mel, band, nfilters);
  if (tile == 0) {
    float* nc = ncarry + s * st.ncarry_s;
    for (int i = threadIdx.x; i < P; i += blockDim.x)
      nc[i * st.ncarry_p] = emph_f32(cs, xs, pv, static_cast<long long>(C) + i, P, C, st);
  }
  __syncthreads();
  const int g = f0 + static_cast<int>(threadIdx.x) / kLanes;
  if (g >= F) return;
  // E at sample pairs, window * 1/nfft, packed z[m] = y[2m] + i*y[2m+1],
  // lane l's register r holding z[l + 32r]
  double2 z[1 << LOG2P];
#pragma unroll
  for (int r = 0; r < (1 << LOG2P); ++r) {
    const int m = lane() + 32 * r;
    const long long q = s0 + static_cast<long long>(g) * hop + 2 * m;
    const double a = static_cast<double>(emph_f32(cs, xs, pv, q, P, C, st));
    const double b = static_cast<double>(emph_f32(cs, xs, pv, q + 1, P, C, st));
    z[r] = window_pair(a, b, win[m]);
  }
  ladder_tail<LOG2P>(z, sm, nfilters, ncep, mel, dct, band, mel_floor,
                     out + (s * F + g) * ncep);
}

// The split-DFT float step: K4-float's ingest (the same f32 emphasized
// values and the same new carry) in front of K5's tail, on K5's persistent
// grid over the flattened (S x F) frame slots.  The new carry of
// stream s is written by the tile that holds its frame slot 0.
template <typename In, int PASSES, int CT, int NT>
__global__ void __launch_bounds__(dmma_product::kThreads, 1)
stream_r2_kernel(radix2_stages::Geometry geo, long long M,
                 const dmma_product::OpT* __restrict__ op,
                 const float* __restrict__ carry, const In* __restrict__ chunk,
                 const int* __restrict__ start, const float* __restrict__ prev,
                 float* __restrict__ out, float* __restrict__ ncarry, int P,
                 int C, int F, int hop, int nfilters, int ncep, Strides st,
                 radix2_stages::Tables tb, float mel_floor) {
  using namespace radix2_stages;
  extern __shared__ __align__(16) unsigned char r2_smem[];
  run<PASSES, CT, NT>(r2_smem, geo, M, op, tb, nfilters, ncep, mel_floor, out,
                      [&](const Smem& sm, long long G0) {
    const int nh = sm.nh, n = sm.FT * nh;
    frame_table(sm, G0, M, F);
    // kU sample pairs a thread in flight: their loads first, then the stores
    for (int i0 = threadIdx.x; i0 < n; i0 += kU * kConsumers) {
      float ye[kU], yo[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kConsumers;
        ye[u] = yo[u] = 0.0f;
        const int2 sg = i < n ? sm.fr[i >> sm.log2nh] : make_int2(-1, 0);
        if (sg.x >= 0) {
          const long long s = sg.x;
          const float* cs = carry + s * st.carry_s;
          const In* xs = chunk + s * st.chunk_s;
          const float pv = prev[s];
          const long long q = start[s] + static_cast<long long>(sg.y) * hop +
                              2 * (i & (nh - 1));
          ye[u] = emph_f32(cs, xs, pv, q, P, C, st);
          yo[u] = emph_f32(cs, xs, pv, q + 1, P, C, st);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kConsumers;
        if (i >= n) break;
        const int f = i >> sm.log2nh, m = i & (nh - 1);
        if (sm.fr[f].x >= 0)
          put_pair<PASSES>(sm, f, m, ye[u], yo[u], tb.we, tb.wo);
        else
          put_zero<PASSES>(sm, f, m);
      }
    }
    // the new carry of the streams whose slot 0 is in this tile
    const long long G1 = G0 + sm.FT < M ? G0 + sm.FT : M;
    const long long s0 = (G0 + F - 1) / F, s1 = (G1 + F - 1) / F;
    for (long long i = threadIdx.x; i < (s1 - s0) * P; i += kConsumers) {
      const long long s = s0 + i / P;
      const int p = static_cast<int>(i - (s - s0) * P);
      ncarry[s * st.ncarry_s + p * st.ncarry_p] = emph_f32(
          carry + s * st.carry_s, chunk + s * st.chunk_s, prev[s],
          static_cast<long long>(C) + p, P, C, st);
    }
    consumer_sync();
  }, [](const Smem&, long long) {});   // the step's input is small and strided
}

template <typename In>
__global__ void __launch_bounds__(int_stages::kThreads)
stream_int_kernel(const int* __restrict__ carry, const In* __restrict__ chunk,
                  const int* __restrict__ start, const int* __restrict__ prev,
                  int* __restrict__ out, int* __restrict__ ncarry, int P, int C,
                  int F, int hop, int tiles_per_stream, Strides st,
                  const int* __restrict__ curve, const int2* __restrict__ tw,
                  int_stages::Tail c) {
  using namespace int_stages;
  __shared__ Smem sm;
  const long long s = blockIdx.x / tiles_per_stream;
  const int tile = static_cast<int>(blockIdx.x % tiles_per_stream);
  const int f0 = tile * kFrames;
  const int* cs = carry + s * st.carry_s;
  const In* xs = chunk + s * st.chunk_s;
  const int s0 = start[s];
  const int pv = prev[s];

  load_ladder_tables(sm, tw);
  load_tail_tables(sm, c);
  if (tile == 0) {
    int* nc = ncarry + s * st.ncarry_s;
    for (int i = threadIdx.x; i < P; i += blockDim.x)
      nc[i * st.ncarry_p] = emph_int(cs, xs, pv, static_cast<long long>(C) + i, P, C, st);
  }
  __syncthreads();
  const int g = f0 + static_cast<int>(threadIdx.x) / kLanes;
  if (g >= F) return;
  int re[kPts];
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    const int p = first_sample(r);
    const long long q = s0 + static_cast<long long>(g) * hop + p;
    re[r] = window(emph_int(cs, xs, pv, q, P, C, st), curve[p]);
  }
  tail(re, sm, c, out + (s * F + g) * c.ncep);
}

// Checks shared by both steps; returns the tiles per stream, or 0.
long long tiles_for(long long S, int P, int C, int F, int hop, int nfft,
                    int frames_per_tile) {
  if (S < 0 || C < 1 || hop < 1 || P != nfft - 1 || F != (C - 1) / hop + 1)
    return 0;
  const long long tiles = (F + frames_per_tile - 1) / frames_per_tile;
  if (S * tiles > 0x7fffffffLL) return 0;
  return tiles;
}

template <typename In>
int launch_f32(const float* carry, const In* chunk, const int* start,
               const float* prev, float* out, float* ncarry, long long S,
               int P, int C, int F, int hop, int nfft, int nfilters, int ncep,
               const Strides& st, const double* win, const double* tw,
               const double* mel, const double* dct, const int* band,
               double mel_floor, void* stream) {
  using namespace fladder_stages;
  const long long tiles = tiles_for(S, P, C, F, hop, nfft, kFrames);
  if (log2_nfft(nfft) < 0 || tiles == 0 || nfilters < 1 ||
      nfilters > nfft / 2 || ncep < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const size_t smem = smem_bytes(nfft);
  return with_points(nfft, [&](auto pts) {
    constexpr int L = decltype(pts)::value;
    const int err = allow_smem(stream_f32_kernel<In, L>, smem);
    if (err != 0) return err;
    stream_f32_kernel<In, L><<<static_cast<unsigned>(S * tiles), kThreads,
                               smem, static_cast<cudaStream_t>(stream)>>>(
        carry, chunk, start, prev, out, ncarry, P, C, F, hop, nfilters, ncep,
        static_cast<int>(tiles), st, reinterpret_cast<const double2*>(win),
        reinterpret_cast<const double2*>(tw), mel, dct,
        reinterpret_cast<const int2*>(band), mel_floor);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename In>
int launch_step_r2(const float* carry, const In* chunk, const int* start,
                   const float* prev, float* out, float* ncarry, long long S,
                   int P, int C, int F, int hop, int nfft, int nfilters,
                   int ncep, const Strides& st, int passes,
                   const dmma_product::Operator& o,
                   const radix2_stages::Tables& tb, double mel_floor,
                   void* stream) {
  using namespace radix2_stages;
  if (!geometry_ok(nfft, passes, nfilters, ncep) ||
      tiles_for(S, P, C, F, hop, nfft, 1) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float fl = static_cast<float>(mel_floor);
  return dispatch(passes, nfft, [&](auto p, auto ct, auto nt) {
    return launch_r2(stream_r2_kernel<In, decltype(p)::value,
                                      decltype(ct)::value, decltype(nt)::value>,
                     S * F, nfft, nfilters, ncep, passes, o, tb, stream, carry,
                     chunk, start, prev, out, ncarry, P, C, F, hop, nfilters,
                     ncep, st, tb, fl);
  });
}

template <typename In>
int launch_int(const int* carry, const In* chunk, const int* start,
               const int* prev, int* out, int* ncarry, long long S, int P,
               int C, int F, int hop, const Strides& st, int nfilters,
               int ncep, int fb_shift, int log_precision, int log_width,
               const int* curve, const int* tw, const int* dtw,
               const long long* fbw, const int* band, void* stream) {
  using namespace int_stages;
  const Tail c = make_tail(fbw, band, dtw, nfilters, ncep, fb_shift,
                           log_precision, log_width);
  const long long tiles = tiles_for(S, P, C, F, hop, kNfft, kFrames);
  if (!tail_ok(c) || tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  stream_int_kernel<In><<<static_cast<unsigned>(S * tiles), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      carry, chunk, start, prev, out, ncarry, P, C, F, hop,
      static_cast<int>(tiles), st, curve, reinterpret_cast<const int2*>(tw), c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  carry and ncarry (new carry, which
// must not overlap carry) hold S x P values and chunk S x C, each addressed
// through its (stream, position) element strides; start (S,) int32 and prev
// (S,) (f32 for the float step, int32 for the INT step); out is (S, F, ncep)
// contiguous.  The tables are K1's (window/nfft, twiddles, mel, dct, band:
// see fladder.cu) for the float step and K2's (curve, tw, dtw, fbw, band:
// see int_mfcc.cu) for the INT step.  Launches on `stream`, on the calling
// thread's current device (the caller sets it), without synchronizing;
// returns a cudaError_t (0 = launched).
extern "C" int mfcc_stream_f32_i16(const float* carry, const int16_t* chunk, const int* start,
                      const float* prev, float* out, float* ncarry, long long S,
                      int P, int C, int F, int hop, int nfft, int nfilters,
                      int ncep, long long carry_s, long long carry_p,
                      long long chunk_s, long long chunk_t, long long ncarry_s,
                      long long ncarry_p, const double* win, const double* tw,
                      const double* mel, const double* dct, const int* band,
                      double mel_floor, void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  return launch_f32(carry, chunk, start, prev, out, ncarry, S, P, C, F, hop,
                    nfft, nfilters, ncep, st, win, tw, mel, dct, band,
                    mel_floor, stream);
}

extern "C" int mfcc_stream_f32_f32(const float* carry, const float* chunk, const int* start,
                      const float* prev, float* out, float* ncarry, long long S,
                      int P, int C, int F, int hop, int nfft, int nfilters,
                      int ncep, long long carry_s, long long carry_p,
                      long long chunk_s, long long chunk_t, long long ncarry_s,
                      long long ncarry_p, const double* win, const double* tw,
                      const double* mel, const double* dct, const int* band,
                      double mel_floor, void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  return launch_f32(carry, chunk, start, prev, out, ncarry, S, P, C, F, hop,
                    nfft, nfilters, ncep, st, win, tw, mel, dct, band,
                    mel_floor, stream);
}

// The split-DFT float step: the arguments of mfcc_stream_f32_* up to the
// strides, then passes (3, 4 or 6), the engine's operator (op, op_rows,
// chunk_rows) and K5's tables (we, wo, tw, melw,
// moff, dct, band, mel_len: see float_fused.cu).
extern "C" int mfcc_stream_r2_i16(const float* carry, const int16_t* chunk, const int* start,
                      const float* prev, float* out, float* ncarry, long long S,
                      int P, int C, int F, int hop, int nfft, int nfilters,
                      int ncep, long long carry_s, long long carry_p,
                      long long chunk_s, long long chunk_t, long long ncarry_s,
                      long long ncarry_p, int passes, const void* op,
                      int op_rows, int chunk_rows, const float* we,
                      const float* wo,
                      const float* tw, const float* melw, const int* moff,
                      const float* dct, const int* band, int mel_len,
                      double mel_floor, void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  const dmma_product::Operator o{op, op_rows, chunk_rows};
  const radix2_stages::Tables tb{we, wo, tw, melw, moff, dct, band,
                                 mel_len};
  return launch_step_r2(carry, chunk, start, prev, out, ncarry, S, P, C, F,
                        hop, nfft, nfilters, ncep, st, passes, o, tb,
                        mel_floor, stream);
}

extern "C" int mfcc_stream_r2_f32(const float* carry, const float* chunk, const int* start,
                      const float* prev, float* out, float* ncarry, long long S,
                      int P, int C, int F, int hop, int nfft, int nfilters,
                      int ncep, long long carry_s, long long carry_p,
                      long long chunk_s, long long chunk_t, long long ncarry_s,
                      long long ncarry_p, int passes, const void* op,
                      int op_rows, int chunk_rows, const float* we,
                      const float* wo,
                      const float* tw, const float* melw, const int* moff,
                      const float* dct, const int* band, int mel_len,
                      double mel_floor, void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  const dmma_product::Operator o{op, op_rows, chunk_rows};
  const radix2_stages::Tables tb{we, wo, tw, melw, moff, dct, band,
                                 mel_len};
  return launch_step_r2(carry, chunk, start, prev, out, ncarry, S, P, C, F,
                        hop, nfft, nfilters, ncep, st, passes, o, tb,
                        mel_floor, stream);
}

extern "C" int mfcc_stream_int_i16(const int* carry, const int16_t* chunk, const int* start,
                      const int* prev, int* out, int* ncarry, long long S,
                      int P, int C, int F, int hop, long long carry_s,
                      long long carry_p, long long chunk_s, long long chunk_t,
                      long long ncarry_s, long long ncarry_p, int nfilters,
                      int ncep, int fb_shift, int log_precision, int log_width,
                      const int* curve, const int* tw, const int* dtw,
                      const long long* fbw, const int* band, void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  return launch_int(carry, chunk, start, prev, out, ncarry, S, P, C, F, hop,
                    st, nfilters, ncep, fb_shift, log_precision, log_width,
                    curve, tw, dtw, fbw, band, stream);
}

extern "C" int mfcc_stream_int_i32(const int* carry, const int* chunk, const int* start,
                      const int* prev, int* out, int* ncarry, long long S,
                      int P, int C, int F, int hop, long long carry_s,
                      long long carry_p, long long chunk_s, long long chunk_t,
                      long long ncarry_s, long long ncarry_p, int nfilters,
                      int ncep, int fb_shift, int log_precision, int log_width,
                      const int* curve, const int* tw, const int* dtw,
                      const long long* fbw, const int* band, void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  return launch_int(carry, chunk, start, prev, out, ncarry, S, P, C, F, hop,
                    st, nfilters, ncep, fb_shift, log_precision, log_width,
                    curve, tw, dtw, fbw, band, stream);
}
