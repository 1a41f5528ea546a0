// SeamlessM4T's fbank (config.SeamlessFbankConfig; Hugging Face's
// SeamlessM4TFeatureExtractor) on ragged batches, for Hopper (sm_90a): two
// kernels behind one C entry.
//
//   K12       fbank_walk<In>  (B, T) int16/f32 audio, the utterances' own
//                             frames -> (own frames, nfilters) FP64 ln-mel
//   K12-cmvn  fbank_cmvn      -> (B, F_pad, nfilters) f32 normalised, the
//                             (B, F_pad / 2) int32 attention mask
//
// K12 is the FP64 walk of K1-Kaldi (fladder.cu's tail_walk with
// KaldiIngest) with two changes: its work list is ragged, and its tail
// stops at the log.  The walk is a __global__ of its own, beside tail_walk
// rather than new template parameters of it, so that tail_walk's parameter
// list and its seven instantiations stay as they were (a by-value struct
// parameter once cost K1 0.8% through register allocation).  It shares
// everything per frame: kaldi_ingest (the frame's mean removed, emphasis
// inside it, the povey window, zero padding to 512), ladder_power (the
// packed 256-point FFT, the unpack, |X|^2) and mel_log2 (the balanced mel
// schedule, 16 steps a lane for the 80 bins' 501 terms, the FLT_EPSILON
// floor and log2) from fladder_stages.cuh.
//
//  * Ragged work list.  A (B, T) batch padded to its longest utterance
//    holds ~48% padding frames when the lengths are uniform over 1-20 s.
//    The walk takes G over the own frames only, sum_s F_s of them: starts
//    (B + 1 int64, the frames' exclusive prefix sum, made on the host from
//    the lengths) maps G to utterance s = the last with starts[s] <= G, by
//    a search the warp makes in step (log2 B loads through L1, ~10 at B =
//    384, against the frame's ~2,200 instructions), and to its frame G -
//    starts[s].  The persistent grid and the frame a warp are tail_walk's.
//  * Log-mel tail.  Lane m stores filter m's log2 times ln 2, Kaldi's
//    natural log, in FP64 at row G of the ln-mel buffer: 80 filters take
//    three gather-and-log2 rounds of mel_log2 (32 + 32 + 16) and no DCT.
//
// K12-cmvn normalises each utterance's bins over its own frames.  The
// statistics span the utterance, so they cannot be taken inside the walk,
// which ends frames of one utterance on many SMs; a second kernel reads the
// FP64 ln-mel back, twice.  A block of 256 threads takes an utterance and
// 16 bins (one 128-byte line of each FP64 row), thread (r, b) bin b of
// frames r, r + 16, ...:
//  * statistics in FP64 without cancellation: each thread runs Welford's
//    update (mean += d / n, m2 += d (x - mean)), the 16 frame lanes of a
//    bin merge pairwise in a fixed tree (Chan et al.: d = mean_b - mean_a,
//    mean = mean_a + d n_b / n, m2 = m2_a + m2_b + d^2 n_a n_b / n), so a
//    bin's statistics do not depend on the walk's order; at int16 scale a
//    ln-mel's mean is in the tens and its spread a few units, where sums of
//    squares less the squared sum would lose digits;
//  * (x - mean) / sqrt(m2 / (F - 1) + 1e-7) in FP64, rounded to f32 once,
//    stored at frame f of row s of (B, F_pad, nfilters), and 0.0f at f >=
//    F: the stacking is a view of these rows;
//  * the blocks of bins 0-15 write their utterance's mask, pair j's second
//    frame own or not: 2j + 1 < F.
// Each thread loads 4 frames ahead of its updates, for bytes in flight.  At
// the cell's size (H100 80GB HBM3) it runs 0.384 ms, ~2 TB/s; three other
// layouts ran slower: a block an utterance (0.586 ms: one block an SM, the
// longest utterances last), and a moments kernel a 64-frame span with an
// apply kernel a 256-frame tile, rows streamed in order (0.845 ms at 640
// threads a block, 0.498 ms at 320).
//
// What bounds it, at the w2vbert.batch cell (384 utterances of 1-20 s,
// 402,432 own frames, F_pad 1,996): K12 by instruction issue, 2.89 ns a
// frame (1.16 ms; K1-Kaldi with its DCT 3.3 ns); K12-cmvn by bandwidth,
// 258 MB of FP64 ln-mel read twice and 245 MB of f32 written, 0.23 ms at
// 3.35 TB/s against its 0.384.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fladder_stages.cuh"
#include "persistent.cuh"

namespace {

using namespace fladder_stages;

constexpr int kLog2P = 3;                   // nfft 512: 8 points a lane
constexpr int kM = 1 << (5 + kLog2P);       // 256 bins below Nyquist
constexpr double kLn2 = 0.69314718055994530942;
constexpr int kBins = 16;                   // bins a K12-cmvn block
constexpr int kRows = kThreads / kBins;     // its frame lanes
constexpr int kAhead = 4;                   // loads a thread issues ahead

// The utterance that own frame G lies in: the last s with starts[s] <= G.
__device__ __forceinline__ int utterance_of(const long long* __restrict__ starts,
                                            int B, long long G) {
  int lo = 0, hi = B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(starts + mid) <= G) lo = mid; else hi = mid;
  }
  return lo;
}

// K12: each warp takes own frames G in a grid-stride loop, loads frame G -
// starts[s] of row s with Kaldi's ingest and stores its ln-mel row.
template <typename In>
__global__ void __launch_bounds__(kThreads, 3)
fbank_walk(const In* __restrict__ in, double* __restrict__ lnmel,
           const long long* __restrict__ starts, int B, long long T,
           long long frames, int hop, int wlen, double emph, int nfilters,
           const double2* __restrict__ win, const double2* __restrict__ tw,
           const double* __restrict__ mel, const int2* __restrict__ band,
           const double2* __restrict__ msched, int msteps,
           double mel_floor) {
  extern __shared__ double2 smem[];
  const Smem sm = carve(smem, 6 + kLog2P, msteps);
  load_constants(sm, 6 + kLog2P, tw, mel, band, msched, nfilters);
  __syncthreads();

  const int l = lane();
  for (long long G = static_cast<long long>(blockIdx.x) * kFrames + threadIdx.x / kLanes;
       G < frames; G += static_cast<long long>(gridDim.x) * kFrames) {
    const int s = utterance_of(starts, B, G);
    const In* x = in + s * T + (G - __ldg(starts + s)) * hop;
    double2 z[1 << kLog2P];
    kaldi_ingest<kLog2P>(x, wlen, emph, win, z);
    double* pw = ladder_power<kLog2P>(z, sm);
    const double* lm = mel_log2<kM / kMelBinsPerStep>(pw, sm, nfilters, mel,
                                                      band, mel_floor);
    __syncwarp();
    double* row = lnmel + G * nfilters;
    for (int m = l; m < nfilters; m += kLanes) row[m] = lm[m] * kLn2;
    __syncwarp();   // the row is free for the warp's next frame
  }
}

struct Moments {
  double n, mean, m2;
};

__device__ __forceinline__ void welford(Moments& a, double x) {
  a.n += 1.0;
  const double d = x - a.mean;
  a.mean += d / a.n;
  a.m2 += d * (x - a.mean);
}

// Chan et al.'s merge of b into a; either may be empty.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  const double n = a.n + b.n;
  if (b.n == 0.0) return a;
  if (a.n == 0.0) return b;
  const double d = b.mean - a.mean;
  return {n, a.mean + d * (b.n / n), a.m2 + b.m2 + d * d * (a.n * b.n / n)};
}

// K12-cmvn: block s * chunks + c normalises bins [16c, 16c + 16) of
// utterance s.
__global__ void __launch_bounds__(kThreads)
fbank_cmvn(const double* __restrict__ lnmel, float* __restrict__ out,
           int* __restrict__ mask, const long long* __restrict__ starts,
           int nfilters, int Fpad, double var_floor) {
  __shared__ Moments part[kThreads];
  const int chunks = (nfilters + kBins - 1) / kBins;
  const int s = blockIdx.x / chunks;
  const int c = blockIdx.x - s * chunks;
  const int b = threadIdx.x % kBins, r = threadIdx.x / kBins;
  const int bin = c * kBins + b;
  const bool live = bin < nfilters;
  const long long f0 = starts[s];
  const int F = static_cast<int>(starts[s + 1] - f0);
  const double* col = lnmel + f0 * nfilters + bin;

  Moments acc{0.0, 0.0, 0.0};
  if (live) {
    int f = r;
    for (; f + (kAhead - 1) * kRows < F; f += kAhead * kRows) {
      double x[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        x[k] = col[static_cast<long long>(f + k * kRows) * nfilters];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) welford(acc, x[k]);
    }
    for (; f < F; f += kRows)
      welford(acc, col[static_cast<long long>(f) * nfilters]);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kRows / 2; h > 0; h /= 2) {
    if (r < h) part[threadIdx.x] = merge(part[threadIdx.x],
                                         part[threadIdx.x + h * kBins]);
    __syncthreads();
  }
  const Moments t = part[b];
  const double sd = sqrt(t.m2 / (F - 1) + var_floor);

  if (live) {
    float* o = out + static_cast<long long>(s) * Fpad * nfilters + bin;
#pragma unroll 4
    for (int f = r; f < Fpad; f += kRows)
      o[static_cast<long long>(f) * nfilters] =
          f < F ? static_cast<float>(
                      (col[static_cast<long long>(f) * nfilters] - t.mean) / sd)
                : 0.0f;
  }
  if (c == 0) {
    int* m = mask + static_cast<long long>(s) * (Fpad / 2);
    for (int j = threadIdx.x; j < Fpad / 2; j += kThreads)
      m[j] = 2 * j + 1 < F;
  }
}

}  // namespace

// C entry point, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  in holds B rows of T samples (int16
// when in_i16, else f32), utterance s the first of its row; starts holds
// B + 1 int64, utterance s's frames being [starts[s], starts[s + 1]) of the
// own frames (each at least 2, frame f starting at sample f * hop), and
// frames = starts[B].  lnmel is an (frames, nfilters) float64 scratch
// between the kernels, out (B, Fpad, nfilters) f32 and mask (B, Fpad / 2)
// int32, Fpad even and at least every utterance's frames.  wlen and emph
// are the frame length (even, at most nfft) and pre-emphasis; win (nfft,
// the povey window zero-padded), tw (nfft/2 complex twiddles), mel
// (nfft/2 x nfilters), band and the mel schedule msched of msteps steps a
// lane (or null) are fladder.cu's tail tables; mel_floor floors the mel
// sums and var_floor is added to the variance.  nfft must be 512.
// Launches K12 then K12-cmvn on `stream`, on the calling thread's current
// device, without synchronizing; returns a cudaError_t (0 = launched).
extern "C" int seamless_fbank(int in_i16, const void* in, double* lnmel,
                              float* out, int* mask, const long long* starts,
                              long long B, long long T, int Fpad,
                              long long frames, int hop, int nfft, int wlen,
                              double emph, int nfilters, const double* win,
                              const double* tw, const double* mel,
                              const int* band, const void* msched,
                              int msteps, double mel_floor,
                              double var_floor, void* stream) {
  const long long chunks = (nfilters + kBins - 1) / kBins;
  if (nfft != 512 || hop < 1 || wlen < 2 || wlen % 2 || wlen > nfft ||
      nfilters < 1 || nfilters > nfft / 2 || B < 0 || Fpad < 2 ||
      Fpad % 2 || frames < 2 * B || T < wlen || B * chunks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto walk = [&](auto* typed) {
    using In = std::remove_const_t<std::remove_pointer_t<decltype(typed)>>;
    return launch_persistent(
        fbank_walk<In>, kThreads, (frames + kFrames - 1) / kFrames,
        smem_bytes(nfft), stream, typed, lnmel, starts,
        static_cast<int>(B), T, frames, hop, wlen, emph, nfilters,
        reinterpret_cast<const double2*>(win),
        reinterpret_cast<const double2*>(tw), mel,
        reinterpret_cast<const int2*>(band),
        static_cast<const double2*>(msched),
        mel_steps(msched, msteps, nfft), mel_floor);
  };
  const int rc = in_i16 ? walk(static_cast<const int16_t*>(in))
                        : walk(static_cast<const float*>(in));
  if (rc != 0) return rc;
  fbank_cmvn<<<static_cast<unsigned>(B * chunks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      lnmel, out, mask, starts, nfilters, Fpad, var_floor);
  return static_cast<int>(cudaGetLastError());
}
