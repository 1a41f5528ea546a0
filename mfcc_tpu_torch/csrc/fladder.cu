// The FP64-tail batch kernels for Hopper (sm_90a): one persistent walk over
// frames, four ingests.
//
//   K1 (and K6 at an odd hop)  FpgaIngest        (S, T) int16/f32 audio
//   K1-Kaldi                   KaldiIngest       (S, T) int16/f32 audio
//   K7                         F64ishIngest      (S, T) int16/f32 audio
//   K7-frames                  F64ishFramesIngest (M, nfft) f32 frames
//
// each -> (S, F, ncep) or (M, ncep) f32 cepstra, in one kernel.  They
// replace the TPU kernels mfcc_tpu/ops/pallas_fladder.py:_fblk_kernel with
// _fladder_tail (K1, K6) and mfcc_tpu/ops/pallas_df32.py:_f64ish_kernel
// (K7, both entries): the same functions, not their block structure.  Per
// frame: the ingest (emphasis, window * 1/nfft, packing) -> FFT -> |X|^2
// on bins [0, nfft/2) -> mel -> optional max(mel, mel_floor) -> log2 ->
// DCT, everything after the ingest the device code of fladder_stages.cuh,
// which the float serving step (stream_step.cu) shares.
//
// Precision: the interior runs in FP64 and the result is rounded to f32
// once, at the store.  The TPU kernels compute in f32 (K7 in double-f32
// limbs on the MXU) because the TPU has no FP64.  An f32 FFT's absolute
// error is ~1e-7 of the frame's energy, while low mel bands of
// pre-emphasized audio hold down to ~1e-8 of it, and log2 amplifies the
// difference.  On 8 streams x 4 s of the headline input the TPU kernel's
// f32 arithmetic (run in interpret mode on a CPU) reads 3.4e-4 against the
// float64 oracle and an early f32 radix-2 variant of this kernel 5.1e-4,
// against a 5e-4 gate; the final structure has not been read in f32.  In
// FP64 the emphasis is exact for int16 and f32 samples alike and the
// output sits within f32 rounding of the oracle.
//
// Design (fladder_stages.cuh): a persistent grid (persistent.cuh) of blocks
// of 8 warps, as many as the card holds; a block loads its twiddle table
// and mel schedule into shared memory once, and each warp then takes
// frames G in a grid-stride loop, one frame at a time, at every nfft:
//  * the ingest loads the frame's points straight from the input into
//    registers, packed as z[m] = y[2m] + i*y[2m+1], lane l holding z[l +
//    32r]; the audio ingests frame by address (frame G = s*F + g of row s
//    starts at sample g*hop; the sample before it is 0 at t = 0), so
//    overlapped framing is addressing and int16 stays int16;
//  * an nfft/2-point complex FFT, then X[k] = (Z[k] + conj Z[-k])/2 + W^k
//    (Z[k] - conj Z[-k])/2i -- half the butterflies of a complex
//    nfft-point FFT;
//  * the FFT in registers, 8 complex points a lane at nfft 512, radix-2
//    decimation in frequency in passes of 3 + 3 + 2 stages with two
//    exchanges through the warp's swizzled shared row (no bank
//    conflicts); the unpack and power; the mel over the bank's nonzero
//    terms on the balanced schedule, the terms cut evenly over the 32
//    lanes (14 steps a lane for the FPGA bank, where a lane per filter ran
//    the widest band's 38); log2; the DCT a lane per cepstrum, stored
//    coalesced.  No block barrier after the tables'.
// The ingest type fixes at compile time what its kernel is: K7's floor is
// the literal 0 (the tail's max drops out), and only the audio ingests
// divide G by F.  The ingests' scalars are the walk's own parameters,
// gathered in the kernel: read from a struct parameter inside the walk
// they changed the register allocation of the audio kernels (K1 ~0.8%
// slower on the H100).  Offsets are 64-bit: S*T passes 2^31 at S=4096 x
// 60 s.
//
// What bounds it, per call at the headline size (S=1024 x T=63,922, nfft
// 512, hop 170: 382,976 frames): ~131 MB of int16 in and ~49 MB of f32
// out, ~54 us of HBM time at 3.35 TB/s (K7-frames reads 784 MB of f32
// frames, 0.25 ms); ~19.6 kFLOP of FP64 per frame as chip_smoke.py counts
// the function (the FFT as radix-4 passes), ~7.5 GFLOP per call (0.22 ms
// at the card's 34 TFLOP/s outside the tensor cores).  The walk is bound
// by instruction issue, ~1.01 ms a call for K1 at the headline (H100):
// tools/sass_mix.py counts 2,912 static SASS instructions in its nfft-512
// instantiation, 2,036 in the body of its walk over frames with each inner
// loop (the mel schedule unrolled whole, the gather and log2, the DCT
// unrolled by 16, and the paths a frame of the FPGA recipe never takes:
// the lane-per-filter fallback, the DCT's remainder) counted once; ~730 of
// a frame's are FP64 (the FP64 pipe ~half busy), the rest mostly IMAD and
// LOP3 of address and index work and shared loads and stores.  A design
// with a block per 4 frames and radix-4 passes through shared memory, 7
// barriers a block, makes ~5.5k 16-byte shared accesses a frame and takes
// ~2 ms.
//
// Left for later work: index and address work, radix-4 passes in
// registers, and f32 or double-f32 arithmetic where the gate allows it.
// The TPU-only structure of the Pallas kernels is not carried: the
// sigma/evenodd8 row order, (8, lanes) sublane blocks with the regroup
// permutation, 128-lane frame tiles, rolls, the super-block chunking with
// SMEM carries, and K7's limbs, TwoSums and LUT log2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fladder_stages.cuh"
#include "persistent.cuh"

namespace {

using namespace fladder_stages;

// The ingests' run-time scalars, from the walk's parameters: each ingest
// reads the ones it needs.  Frames by address into (S, T) rows: frame G =
// s*F + g starts at sample g*hop of row s.
struct Scalars {
  long long T;
  int F, hop;
  int wlen;        // Kaldi's frame length
  double emph;     // Kaldi's pre-emphasis
  int wire_grid;   // K7's 2^-5 grid, 0 or 1

  template <typename In>
  __device__ __forceinline__ const In* frame(const In* audio, long long G,
                                             int& g) const {
    const long long s = G / F;
    g = static_cast<int>(G - s * F);
    return audio + s * T + static_cast<long long>(g) * hop;
  }
};

// K1 (and K6): the FPGA recipe's pre-emphasis y = x - 0.96875*prev in
// FP64, then the window * 1/nfft on sample pairs; the tail's floor is the
// caller's mel_floor.
constexpr double kEmph = 0.96875;   // 1 - 1/32

template <typename Input>
struct FpgaIngest {
  using In = Input;

  __device__ __forceinline__ static double tail_floor(double mel_floor) {
    return mel_floor;
  }

  template <int LOG2P>
  __device__ __forceinline__ static void load(
      const Scalars& a, const In* __restrict__ audio, long long G, int l,
      const double2* __restrict__ win, double2 (&z)[1 << LOG2P]) {
    int g;
    const In* x = a.frame(audio, G, g);
#pragma unroll
    for (int r = 0; r < (1 << LOG2P); ++r) {
      const int m = l + 32 * r;
      const double p = g > 0 || m > 0 ? static_cast<double>(x[2 * m - 1]) : 0.0;
      const double a0 = static_cast<double>(x[2 * m]);
      const double b = static_cast<double>(x[2 * m + 1]);
      z[r] = window_pair(a0 - kEmph * p, b - kEmph * a0, win[m]);
    }
  }
};

// K1-Kaldi (config.KaldiConfig): kaldi_ingest (fladder_stages.cuh) on the
// frame's wlen raw samples: the frame's mean removed and its own
// pre-emphasis by emph, the povey window without 1/nfft, zero padding to
// nfft.  The tail's constants are the recipe's: its mel banks, mel_floor =
// FLT_EPSILON, and the DCT with ln 2 and the lifter folded in, so the
// tail's log2 gives Kaldi's natural log.
template <typename Input>
struct KaldiIngest {
  using In = Input;

  __device__ __forceinline__ static double tail_floor(double mel_floor) {
    return mel_floor;
  }

  template <int LOG2P>
  __device__ __forceinline__ static void load(
      const Scalars& a, const In* __restrict__ audio, long long G, int,
      const double2* __restrict__ win, double2 (&z)[1 << LOG2P]) {
    int g;
    kaldi_ingest<LOG2P>(a.frame(audio, G, g), a.wlen, a.emph, win, z);
  }
};

// K7, the f64ish function (ops/f64ish.py): pre-emphasis in f32, then
// optionally the 2^-5 wire grid, rint(y*32)/32 in FP64, then the window *
// 1/nfft.  Rounding, each step on purpose:
//  * emphasis in f32, rounded twice (__fmul_rn / __fsub_rn): nvcc would
//    contract it into an FMA, and the JAX chain rounds twice.  For int16
//    samples the f32 result is exact (<= 21 significant bits), so on int16
//    input K7 computes K1's values bit for bit;
//  * the grid step rounds half to even (rint, as jnp.round in the JAX
//    chain df32.py).  The JAX kernel truncates x*32 instead
//    (pallas_df32.py:272), which differs off the grid; the pipeline's route
//    is the chain.  Neither C round (half away from zero) nor truncation is
//    used.  The step is exact for finite f32 input (x*32 and /32 are
//    power-of-two scalings), so unlike the JAX chain's int32 cast it never
//    wraps; wire_grid is defined for int16-range samples either way;
//  * no floor: the f64ish mode has none (digital silence gives -inf / NaN,
//    as in the JAX package).
__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ float emph_f32(float x, float p) {
  return __fsub_rn(x, __fmul_rn(0.96875f, p));
}

// An emphasized f32 sample in FP64, on the 2^-5 grid (half to even) when
// wire_grid.
__device__ __forceinline__ double grid(float y, int wire_grid) {
  const double v = static_cast<double>(y);
  return wire_grid ? rint(v * 32.0) * 0.03125 : v;
}

template <typename Input>
struct F64ishIngest {
  using In = Input;

  __device__ __forceinline__ static double tail_floor(double) { return 0.0; }

  template <int LOG2P>
  __device__ __forceinline__ static void load(
      const Scalars& a, const In* __restrict__ audio, long long G, int l,
      const double2* __restrict__ win, double2 (&z)[1 << LOG2P]) {
    int g;
    const In* x = a.frame(audio, G, g);
#pragma unroll
    for (int r = 0; r < (1 << LOG2P); ++r) {
      const int m = l + 32 * r;
      const float p = g > 0 || m > 0 ? to_f32(x[2 * m - 1]) : 0.0f;
      const float a0 = to_f32(x[2 * m]);
      const float b = to_f32(x[2 * m + 1]);
      z[r] = window_pair(grid(emph_f32(a0, p), a.wire_grid),
                         grid(emph_f32(b, a0), a.wire_grid), win[m]);
    }
  }
};

// K7-frames: row G of (M, nfft) pre-emphasized f32 frames, on the grid as
// K7; no framing, so no division by F.
struct F64ishFramesIngest {
  using In = float;

  __device__ __forceinline__ static double tail_floor(double) { return 0.0; }

  template <int LOG2P>
  __device__ __forceinline__ static void load(
      const Scalars& a, const In* __restrict__ frames, long long G, int l,
      const double2* __restrict__ win, double2 (&z)[1 << LOG2P]) {
    const float* row = frames + G * (64 << LOG2P);
#pragma unroll
    for (int r = 0; r < (1 << LOG2P); ++r) {
      const int m = l + 32 * r;
      z[r] = window_pair(grid(row[2 * m], a.wire_grid),
                         grid(row[2 * m + 1], a.wire_grid), win[m]);
    }
  }
};

// Blocks an SM must hold at once, which caps the registers: 64 a thread at
// nfft 256 (4 blocks), 80 at 512 (3; at 4 K1 spills 152 bytes and runs ~8%
// slower, at 2 K7 takes 118 registers and runs ~5% slower), 128 at 1024
// (2, all its shared memory allows).
template <int LOG2P>
constexpr int kResident = LOG2P == 4 ? 2 : LOG2P == 3 ? 3 : 4;

// The walk: each warp takes frames G in a grid-stride loop, has the ingest
// load the frame's points and runs the tail on them.
template <typename Ingest, int LOG2P>
__global__ void __launch_bounds__(kThreads, kResident<LOG2P>)
tail_walk(const typename Ingest::In* __restrict__ in,
          float* __restrict__ out, long long T, int F, int hop,
          long long frames, int nfilters, int ncep,
          const double2* __restrict__ win, const double2* __restrict__ tw,
          const double* __restrict__ mel, const double* __restrict__ dct,
          const int2* __restrict__ band, const double2* __restrict__ msched,
          int msteps, double mel_floor, int wlen, double emph,
          int wire_grid) {
  extern __shared__ double2 smem[];
  constexpr int log2m = 5 + LOG2P;
  const Smem sm = carve(smem, log2m + 1, msteps);
  load_constants(sm, log2m + 1, tw, mel, band, msched, nfilters);
  __syncthreads();

  const Scalars a{T, F, hop, wlen, emph, wire_grid};
  const int l = lane();
  for (long long G = static_cast<long long>(blockIdx.x) * kFrames + threadIdx.x / kLanes;
       G < frames; G += static_cast<long long>(gridDim.x) * kFrames) {
    double2 z[1 << LOG2P];
    Ingest::template load<LOG2P>(a, in, G, l, win, z);
    ladder_tail<LOG2P>(z, sm, nfilters, ncep, mel, dct, band,
                       Ingest::tail_floor(mel_floor), out + G * ncep);
  }
}

// the ingests, as mfcc_tail_walk's first argument names them
// (ops/fladder.py FPGA, KALDI, F64ISH, F64ISH_FRAMES)
enum { kFpga, kKaldi, kF64ish, kF64ishFrames };

}  // namespace

// C entry point, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  `ingest` is one of the four above,
// in_i16 is 1 for int16 input and 0 for f32 (the frames ingest takes f32
// only).  `in` holds S rows of T samples, F frames a row at `hop`; the
// frames ingest takes S rows of one frame each (T = nfft, F = 1).  wlen
// and emph are Kaldi's frame length (even, at most nfft; a row must hold
// (F-1)*hop + wlen samples, nfft for the other ingests) and pre-emphasis
// coefficient, read by its ingest only.  win (nfft; the window * 1/nfft,
// Kaldi's zero-padded without it), mel (nfft/2 x nfilters, the Nyquist row
// dropped) and dct (nfilters x ncep) are float64, row-major; tw holds
// nfft/2 interleaved complex float64 twiddles exp(-2*pi*i*k/nfft); band
// holds nfilters int32 pairs [lo, hi) outside which a mel column is zero;
// msched is the balanced mel schedule of msteps steps a lane
// (ops/fladder.py mel_schedule: 16-byte entries, then nfilters gather
// words), or null: with no schedule, or one over the table's capacity
// (mel_steps), the mel runs a lane per filter over its band.  mel_floor
// is read by the FPGA and Kaldi ingests (0: no floor), wire_grid (0 or 1)
// by K7's.  Out is (S, F, ncep) f32.  Launches on `stream`, on the calling
// thread's current device (the caller sets it), without synchronizing;
// returns a cudaError_t (0 = launched).
extern "C" int mfcc_tail_walk(int ingest, int in_i16, const void* in,
                              float* out, long long S, long long T, int F,
                              int hop, int nfft, int wlen, double emph,
                              int nfilters, int ncep, const double* win,
                              const double* tw, const double* mel,
                              const double* dct, const int* band,
                              const void* msched, int msteps,
                              double mel_floor, int wire_grid,
                              void* stream) {
  const int len = ingest == kKaldi ? wlen : nfft;   // a frame's samples
  if (ingest < kFpga || ingest > kF64ishFrames || log2_nfft(nfft) < 0 ||
      F < 1 || hop < 1 || nfilters < 1 || nfilters > nfft / 2 || ncep < 1 ||
      S < 0 || len < 2 || len % 2 || len > nfft ||
      T < static_cast<long long>(F - 1) * hop + len ||
      (ingest == kF64ishFrames && (in_i16 || F != 1 || T != nfft)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const long long frames = S * F;
  // the walk with the ingest of `tag`'s type, persistent over the frames
  const auto walk = [&](auto tag) {
    using Ingest = decltype(tag);
    return with_points(nfft, [&](auto pts) {
      constexpr int L = decltype(pts)::value;
      return launch_persistent(
          tail_walk<Ingest, L>, kThreads, (frames + kFrames - 1) / kFrames,
          smem_bytes(nfft), stream,
          static_cast<const typename Ingest::In*>(in), out, T, F, hop,
          frames, nfilters, ncep, reinterpret_cast<const double2*>(win),
          reinterpret_cast<const double2*>(tw), mel, dct,
          reinterpret_cast<const int2*>(band),
          static_cast<const double2*>(msched),
          mel_steps(msched, msteps, nfft), mel_floor, wlen, emph, wire_grid);
    });
  };
  switch (ingest) {
    case kFpga:
      return in_i16 ? walk(FpgaIngest<int16_t>())
                    : walk(FpgaIngest<float>());
    case kKaldi:
      return in_i16 ? walk(KaldiIngest<int16_t>())
                    : walk(KaldiIngest<float>());
    case kF64ish:
      return in_i16 ? walk(F64ishIngest<int16_t>())
                    : walk(F64ishIngest<float>());
  }
  return walk(F64ishFramesIngest());
}
