// Device functions of the bit-exact INT MFCC pipeline: the RTL's integer
// arithmetic (mfcc_tpu_torch/ref/int_ref.py holds the derivations), for
// the reference's 16-bit datapath (width 16, window precision 8, power
// width 30, nfft 512).  Shared by the fused INT kernels of int_mfcc.cu (K2
// from raw audio, K3 from pre-emphasized frames), by the INT serving step
// K4 of stream_step.cu, the same tail behind a carry-aware ingest, and by
// the two launches of K10 (int_split2.cu), which cut the tail at the power.
//
// Signed overflow is undefined in C++, while the reference's int32 stages
// wrap mod 2^32 (the exactness argument of ops/int_ops.py needs the wrap).
// Every product or sum that can leave int32 range is therefore taken in
// uint32_t and converted back before an arithmetic shift: the window product
// of arbitrary int32 frames, the butterfly's m0 + bias - m1, the power
// r*r + i*i, the log2's z*z.  The filterbank accumulates mod 2^64 in
// uint64_t.  Right shifts of signed values are arithmetic (nvcc).
//
// Layout: a block holds `nrows` frames in two shared int32 arrays (real,
// imaginary), one row per frame, row stride `row`; a row's point i sits at
// pad(i) = i + i/16, which spreads the bit-reversed stores of the load over
// the banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int_stages {

constexpr int kLog2Nfft = 9;            // nfft 512
constexpr int kNfft = 1 << kLog2Nfft;
constexpr int kNbins = kNfft / 2;       // FftStream keeps bins [0, nfft/2)
constexpr int kRow = kNfft + kNfft / 16;  // padded row: pad(511) = 542
constexpr int kMaxFilters = 32;
constexpr int kWindowShift = 9;         // >> (window precision + 1)
constexpr int kButterflyShift = 14;     // bias_width = width - 2
constexpr uint32_t kBias = (1u << 13) - 1;  // (1 << bias_width - 1) - 1
constexpr int kPowerShift = 2;          // 2 * width - power width
constexpr int kMelMask = 0xFFFF;        // filterbank output width 16

// Constants of the stages after the 512-point FFT (device pointers).
struct Tail {
  const long long* fbw;  // (nbins, nfilters) int64 filterbank matrix W
  const int2* band;      // nfilters [lo, hi): W[:, j] is zero outside
  const int2* dtw;       // 2 * nfilters (re, im) twiddles of the DCT FFT
  int nfilters;          // 16 or 32; the DCT FFT has 4 * nfilters points
  int ncep;              // cepstra kept, <= nfilters
  int fb_shift;          // the filterbank keeps bits [fb_shift, fb_shift+16)
  int log_precision;     // fraction bits of the log2 (11 for Q4.11)
  int log_width;         // log2 output width (15)
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ int bitrev(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

// Truncate to 16 bits and sign-extend (nMigen signed assignment).
__device__ __forceinline__ int wrap16(int v) {
  return ((v & 0xFFFF) ^ 0x8000) - 0x8000;
}

// Pre-emphasis y = wrap16(x + (prev >> 5) - prev) of int16-range samples
// (mfcc/core/preemph.py:23).
__device__ __forceinline__ int preemph(int x, int prev) {
  return wrap16(x + (prev >> 5) - prev);
}

// The same for full-range int32 samples, the sum taken mod 2^32 as XLA's
// int32 does (the INT serving step takes int32 chunks as they are): in
// uint32_t, after the arithmetic shift of the signed prev.
__device__ __forceinline__ int preemph32(int x, int prev) {
  const uint32_t y = static_cast<uint32_t>(x) + static_cast<uint32_t>(prev >> 5) -
                     static_cast<uint32_t>(prev);
  return wrap16(static_cast<int>(y));
}

// Window wrap16((x * curve) >> 9), the product mod 2^32 for any int32 x
// (mfcc/core/window.py:84).
__device__ __forceinline__ int window(int x, int curve) {
  const int prod = static_cast<int>(static_cast<uint32_t>(x) *
                                    static_cast<uint32_t>(curve));
  return wrap16(prod >> kWindowShift);
}

// The Butterfly datapath (mfcc/misc/fft.py:140-192), int_ref.butterfly_int:
// three multiplies, bias round, >> 14, then >> 1 and wrap16.  Inputs are
// 16-bit values, twiddles 15-bit.
__device__ __forceinline__ void butterfly(int& x0r, int& x0i, int& x1r,
                                          int& x1i, int twr, int twi) {
  const uint32_t m0 = static_cast<uint32_t>(x1r + x1i) * static_cast<uint32_t>(twr);
  const uint32_t m1 = static_cast<uint32_t>(x1i) * static_cast<uint32_t>(twr + twi);
  const uint32_t m2 = static_cast<uint32_t>(x1r) * static_cast<uint32_t>(twr - twi);
  const int sub1 = static_cast<int>(m0 + kBias - m1) >> kButterflyShift;
  const int sub2 = static_cast<int>(m0 + kBias - m2) >> kButterflyShift;
  const int a = x0r, b = x0i;
  x0r = wrap16((a + sub1) >> 1);
  x0i = wrap16((b + sub2) >> 1);
  x1r = wrap16((a - sub1) >> 1);
  x1i = wrap16((b - sub2) >> 1);
}

// |X|^2 as a 32-bit field, top 30 bits: (uint32)(r*r + i*i) >> 2
// (mfcc/core/pow2.py:33,64).
__device__ __forceinline__ int power(int r, int i) {
  const uint32_t s = static_cast<uint32_t>(r * r) + static_cast<uint32_t>(i * i);
  return static_cast<int>(s >> kPowerShift);
}

// Turner's fixed-point log2 (mfcc/core/log.py:57-131): 0 clamps to 1,
// normalize by floor(log2 d) right shifts, then precision-1
// square-and-compare rounds; d < 2^16.
__device__ __forceinline__ int log2fix(int d, int precision, int width_output) {
  if (d == 0) d = 1;
  const int shifts = 31 - __clz(d);
  int z = (d << precision) >> shifts;
  int res = shifts << precision;
  int b = 1 << (precision - 1);
  for (int it = 0; it < precision - 1; ++it) {
    const int c = static_cast<int>(static_cast<uint32_t>(z) * static_cast<uint32_t>(z));
    if ((c >> (2 * precision + 1)) & 1) {
      res += b;
      z = c >> (precision + 1);
    } else {
      z = c >> precision;
    }
    b >>= 1;
  }
  return res & static_cast<int>((1u << width_output) - 1u);
}

// In-place radix-2 DIT FFT of 2^log2n points on each of `nrows` rows,
// whose points were stored in bit-reversed order; the standard schedule of
// tables.dit_stage_plan: stage s pairs i0 = (t >> s) << (s+1) | (t & (2^s-1))
// with i0 + 2^s under twiddle (t & (2^s-1)) << (log2n-1-s).  `tw` holds the
// 2^(log2n-1) twiddles of tables.twiddle_table(2^log2n, 16).  Ends with a
// barrier.
__device__ __forceinline__ void fft_rows(int* re, int* im, int row, int nrows,
                                         int log2n, const int2* tw) {
  const int lhalf = log2n - 1;
  const int half = 1 << lhalf;
  for (int s = 0; s < log2n; ++s) {
    const int span = 1 << s;
    for (int b = threadIdx.x; b < nrows * half; b += blockDim.x) {
      const int t = b & (half - 1);
      const int j = t & (span - 1);
      const int i0 = ((t >> s) << (s + 1)) + j;
      const int base = (b >> lhalf) * row;
      const int p0 = base + pad(i0), p1 = base + pad(i0 + span);
      const int2 w = tw[j << (lhalf - s)];
      int x0r = re[p0], x0i = im[p0], x1r = re[p1], x1i = im[p1];
      butterfly(x0r, x0i, x1r, x1i, w.x, w.y);
      re[p0] = x0r;
      im[p0] = x0i;
      re[p1] = x1r;
      im[p1] = x1i;
    }
    __syncthreads();
  }
}

// The stages after the power, for `nrows` frames whose power rows (natural
// bin order, bins [0, 256)) are in re: the integer mel filterbank mod 2^64
// over each filter's band, log2, and the DCT-II as a 4*nfilters-point INT
// FFT of the scattered log-mel row (buf[2k+1] = buf[4n-1-2k] = logmel[k],
// mfcc/core/dct_stream.py:29-34).  On return re[row r, pad(c)] holds
// cepstrum c of frame r.  `logmel` is shared scratch of nrows * nfilters
// ints, `dtw` the DCT twiddles in shared memory.  Starts after, and ends
// with, a barrier.
__device__ __forceinline__ void post_power_stages(int* re, int* im, int row,
                                                  int nrows, int* logmel,
                                                  const int2* dtw,
                                                  const Tail& c) {
  const int nf = c.nfilters;
  for (int o = threadIdx.x; o < nrows * nf; o += blockDim.x) {
    const int f = o / nf;
    const int j = o - f * nf;
    const int* pw = re + f * row;
    const int2 bd = c.band[j];
    unsigned long long acc = 0;
    for (int k = bd.x; k < bd.y; ++k)
      acc += static_cast<unsigned long long>(static_cast<uint32_t>(pw[pad(k)])) *
             static_cast<unsigned long long>(c.fbw[k * nf + j]);
    const int mel = static_cast<int>(static_cast<long long>(acc) >> c.fb_shift) & kMelMask;
    logmel[o] = log2fix(mel, c.log_precision, c.log_width);
  }
  __syncthreads();

  const int n4 = 4 * nf;
  const int log2n4 = nf == 32 ? 7 : 6;
  for (int b = threadIdx.x; b < nrows * n4; b += blockDim.x) {
    const int f = b >> log2n4;
    const int i = b & (n4 - 1);
    const int src = bitrev(i, log2n4);
    int v = 0;
    if (src & 1) {
      const int k = src < 2 * nf ? (src - 1) >> 1 : (n4 - 1 - src) >> 1;
      v = logmel[f * nf + k];
    }
    re[f * row + pad(i)] = v;
    im[f * row + pad(i)] = 0;
  }
  __syncthreads();
  fft_rows(re, im, row, nrows, log2n4, dtw);
}

// Power on bins [0, 256) of `nrows` spectra (natural bin order) in re/im,
// in place in re.  Ends with a barrier.
__device__ __forceinline__ void power_rows(int* re, const int* im, int row,
                                           int nrows) {
  for (int b = threadIdx.x; b < nrows * kNbins; b += blockDim.x) {
    const int p = (b >> (kLog2Nfft - 1)) * row + pad(b & (kNbins - 1));
    re[p] = power(re[p], im[p]);
  }
  __syncthreads();
}

// The stages after the 512-point FFT: power_rows, then post_power_stages.
// On return re[row r, pad(c)] holds cepstrum c of frame r.  Starts after,
// and ends with, a barrier.
__device__ __forceinline__ void post_fft_stages(int* re, int* im, int row,
                                                int nrows, int* logmel,
                                                const int2* dtw, const Tail& c) {
  power_rows(re, im, row, nrows);
  post_power_stages(re, im, row, nrows, logmel, dtw, c);
}

// -- The block of the fused INT kernels (K2, K3, K4) ------------------------

constexpr int kThreads = 256;
constexpr int kFrames = 8;   // frames per block

// The block's shared memory: kFrames padded FFT rows (re, im), the
// log-mel scratch and both twiddle tables.
struct Smem {
  int re[kFrames * kRow];
  int im[kFrames * kRow];
  int logmel[kFrames * kMaxFilters];
  int2 tw[kNbins];
  int2 dtw[2 * kMaxFilters];
};

__device__ __forceinline__ void load_twiddles(Smem& sm, const int2* tw,
                                              const Tail& c) {
  for (int i = threadIdx.x; i < kNbins; i += blockDim.x) sm.tw[i] = tw[i];
  for (int i = threadIdx.x; i < 2 * c.nfilters; i += blockDim.x)
    sm.dtw[i] = c.dtw[i];
}

// Store frame f's windowed point p at its bit-reversed position.
__device__ __forceinline__ void store_point(Smem& sm, int f, int p, int v) {
  const int q = f * kRow + pad(bitrev(p, kLog2Nfft));
  sm.re[q] = v;
  sm.im[q] = 0;
}

// Everything after the frames are loaded at their bit-reversed positions:
// the 512-point FFT and the post-FFT stages; cepstra end in sm.re.
__device__ __forceinline__ void run_tail(Smem& sm, const Tail& c) {
  __syncthreads();
  fft_rows(sm.re, sm.im, kRow, kFrames, kLog2Nfft, sm.tw);
  post_fft_stages(sm.re, sm.im, kRow, kFrames, sm.logmel, sm.dtw, c);
}

inline bool tail_ok(const Tail& c) {
  return (c.nfilters == 16 || c.nfilters == 32) && c.ncep >= 1 &&
         c.ncep <= c.nfilters && c.fb_shift >= 0 && c.fb_shift < 64 &&
         c.log_precision >= 1 && c.log_precision <= 15 &&
         c.log_width >= 1 && c.log_width <= 31;
}

inline Tail make_tail(const long long* fbw, const int* band, const int* dtw,
                      int nfilters, int ncep, int fb_shift, int log_precision,
                      int log_width) {
  return Tail{fbw, reinterpret_cast<const int2*>(band),
              reinterpret_cast<const int2*>(dtw), nfilters, ncep, fb_shift,
              log_precision, log_width};
}

}  // namespace int_stages
