// Device functions of the bit-exact INT MFCC pipeline: the RTL's integer
// arithmetic (mfcc_tpu_torch/ref/int_ref.py holds the derivations), for
// the reference's 16-bit datapath (width 16, window precision 8, power
// width 30, nfft 512).  Shared by the fused INT kernels of int_mfcc.cu (K2
// from int16 audio, K3-v1 from int32 audio, K3 from pre-emphasized
// frames), by the INT serving step K4 of stream_step.cu, the same tail
// behind a carry-aware ingest, and by the two launches of K10
// (int_split2.cu), which cut the tail at the power.
//
// Signed overflow is undefined in C++, while the reference's int32 stages
// wrap mod 2^32 (the exactness argument of ops/int_ops.py needs the wrap).
// Every product or sum that can leave int32 range is therefore taken in
// uint32_t and converted back before an arithmetic shift: the window product
// of arbitrary int32 frames, the butterfly's m0 + bias - m1, the power
// r*r + i*i, the log2's z*z.  The filterbank accumulates mod 2^64 in
// uint64_t.  Right shifts of signed values are arithmetic (nvcc).
//
// Design: one warp owns one frame, a block of 8 warps 8 frames at a time.
// Each kernel's warp loads its frame's windowed samples straight into the
// ladder's first layout, a lane's register r being sample bitrev(16 lane +
// r) (32 consecutive samples across the lanes), and calls tail(); the
// block's one barrier is the one after its tables.  From there each warp
// runs alone, with __syncwarp only:
//  * the 512-point radix-2 DIT ladder in registers, 16 points a lane: lane
//    l holds points 16l + r for stages 0-3 (spans 1-8, the first with its
//    zero imaginary inputs folded by the compiler), exchanges through its
//    row for points 256(l>>4) + (l&15) + 16k for stages 4-7, and once more
//    for points l + 32k for stage 8, of which only the outputs of bins
//    [0, 256) are computed.  An exchange packs each 16-bit (re, im) pair
//    into one word (every ladder value is a wrap16 output) and is free of
//    bank conflicts but for one lane pair of the second;
//  * the power of bins l + 32k in registers, stored to the row in natural
//    order; the filterbank one lane per filter (two lanes per filter at 16
//    filters, their uint64 sums joined by a shuffle, exact mod 2^64) over
//    its band, the weights read by band offset from a block table; log2 in
//    the same lane;
//  * the 4*nfilters-point DCT ladder in registers: its lower half is zero
//    through every stage but the last (bit-reversed storage puts the
//    scattered log-mel row's odd points in the upper half), so the upper
//    half's 2*nfilters points run one or two a lane, pairs across lanes by
//    shuffles, and lane c takes the last stage's real output c: cepstrum
//    c, stored by lane c (one coalesced store a frame).
// The butterfly is the RTL's datapath, unchanged; only data movement and
// schedule are the kernel's.  What bounds it now is instruction issue,
// ~4.3k SASS instructions a warp per frame (int_mfcc.cu).  Left for later:
// fewer instructions per butterfly and per exchange; the filterbank lanes
// idle on narrow bands (the loop runs the widest band's length, 37 bins,
// for an average of 13).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int kLanes = 32;
constexpr int kPts = kNfft / kLanes;    // ladder points per lane
constexpr int kBinsPerLane = kNbins / kLanes;
constexpr unsigned kFull = 0xffffffffu;
// Filterbank weights kept in shared memory, by band offset (rows t <
// kFbTable / nfilters: 48 at 32 filters, 96 at 16; the widest bands of the
// reference configs are 37 and 70 bins)
constexpr int kFbTable = 1536;

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

__device__ __forceinline__ int lane() { return threadIdx.x & (kLanes - 1); }

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

// wrap16(v >> 1): bits 1..16 of v, sign-extended, as one shift pair.
__device__ __forceinline__ int half_wrap16(int v) {
  return static_cast<int>(static_cast<uint32_t>(v) << 15) >> 16;
}

// The Butterfly datapath (mfcc/misc/fft.py:140-192), int_ref.butterfly_int:
// three multiplies, bias round, >> 14, then >> 1 and wrap16.  Inputs are
// 16-bit values; the twiddle w = (twr, twr + twi, twr - twi), 15-bit twr
// and twi, the two sums being the datapath's constants (the tables hold
// them).
__device__ __forceinline__ void butterfly(int& x0r, int& x0i, int& x1r,
                                          int& x1i, int4 w) {
  const uint32_t m0 = static_cast<uint32_t>(x1r + x1i) * static_cast<uint32_t>(w.x);
  const uint32_t m1 = static_cast<uint32_t>(x1i) * static_cast<uint32_t>(w.y);
  const uint32_t m2 = static_cast<uint32_t>(x1r) * static_cast<uint32_t>(w.z);
  const int sub1 = static_cast<int>(m0 + kBias - m1) >> kButterflyShift;
  const int sub2 = static_cast<int>(m0 + kBias - m2) >> kButterflyShift;
  const int a = x0r, b = x0i;
  x0r = half_wrap16(a + sub1);
  x0i = half_wrap16(b + sub2);
  x1r = half_wrap16(a - sub1);
  x1i = half_wrap16(b - sub2);
}

// A table twiddle (twr, twi) as the butterfly takes it.
__device__ __forceinline__ int4 twiddle(int2 t) {
  return make_int4(t.x, t.x + t.y, t.x - t.y, 0);
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

// A ladder value in one word for an exchange: re in the low 16 bits, im in
// the high 16 (both are wrap16 outputs, so nothing is lost).
__device__ __forceinline__ int pack(int re, int im) {
  return static_cast<int>((static_cast<uint32_t>(re) & 0xFFFFu) |
                          (static_cast<uint32_t>(im) << 16));
}

__device__ __forceinline__ void unpack(int v, int& re, int& im) {
  re = wrap16(v);
  im = v >> 16;
}

// -- The block of the fused INT kernels (K2, K3, K4, K10) -------------------

constexpr int kThreads = 256;
constexpr int kFrames = kThreads / kLanes;   // frames per block, one a warp

// The block's shared memory: one padded row per frame (the exchanges at
// pad(i) = i + i/16, which spreads them over the banks, then the power),
// the ladder's twiddles by stage
// (stage s at (2^s - 1) + j: tables.twiddle_table(512, 16)[j << (8 - s)],
// so that the lanes of a stage read consecutive entries) and the DCT's,
// both as butterfly() takes them, the band limits and the banded
// filterbank weights fbt[t * nfilters + j] = W[lo_j + t, j] (0 past the
// band).
struct Smem {
  int row[kFrames * kRow];
  int4 stw[kNfft - 1];
  int4 dtw[2 * kMaxFilters];
  int2 band[kMaxFilters];
  unsigned long long fbt[kFbTable];
};

// The ladder's twiddle table from the 256 twiddles of twiddle_table(512,
// 16) in global memory; the caller's barrier follows.
__device__ __forceinline__ void load_ladder_tables(Smem& sm, const int2* tw) {
  for (int i = threadIdx.x; i < kNfft - 1; i += blockDim.x) {
    const int s = 31 - __clz(i + 1);
    sm.stw[i] = twiddle(tw[(i + 1 - (1 << s)) << (kLog2Nfft - 1 - s)]);
  }
}

// The post-power tables: DCT twiddles, band limits, banded weights; the
// caller's barrier follows.
__device__ __forceinline__ void load_tail_tables(Smem& sm, const Tail& c) {
  const int nf = c.nfilters;
  for (int i = threadIdx.x; i < 2 * nf; i += blockDim.x)
    sm.dtw[i] = twiddle(c.dtw[i]);
  for (int i = threadIdx.x; i < nf; i += blockDim.x) sm.band[i] = c.band[i];
  for (int e = threadIdx.x; e < kFbTable; e += blockDim.x) {
    const int t = e / nf;
    const int j = e - t * nf;
    const int2 bd = c.band[j];
    sm.fbt[e] = bd.x + t < bd.y
        ? static_cast<unsigned long long>(c.fbw[(bd.x + t) * nf + j]) : 0ull;
  }
}

// The sample lane l's register r holds in the ladder's first layout: point
// 16l + r of the bit-reversed load is sample bitrev(16l + r).  For a fixed
// r the 32 lanes read 32 consecutive samples.
__device__ __forceinline__ int first_sample(int r) {
  return bitrev(16 * lane() + r, kLog2Nfft);
}

// Pre-emphasis by sample type: int16 samples take preemph (K2's wire rule,
// samples mod 2^16), int32 samples preemph32, read whole with the sum mod
// 2^32 (K3-v1's rule, pallas_int.py:1271-1272).
template <typename In>
__device__ __forceinline__ int emphasize(int x, int prev) {
  static_assert(std::is_same_v<In, int16_t> || std::is_same_v<In, int32_t>,
                "int16 or int32 samples");
  if constexpr (std::is_same_v<In, int16_t>) return preemph(x, prev);
  else return preemph32(x, prev);
}

// The ladder's first layout of the frame whose first sample is x[0], int16
// or int32: pre-emphasis (the sample before it is x[-1], or 0 when `first`,
// the signal's start) and the window, lane l's register r holding sample
// first_sample(r).
template <typename In>
__device__ __forceinline__ void load_audio_frame(const In* x, bool first,
                                                 const int* curve,
                                                 int (&re)[kPts]) {
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    const int p = first_sample(r);
    const int prev = first && p == 0 ? 0 : x[p - 1];
    re[r] = window(emphasize<In>(x[p], prev), curve[p]);
  }
}

// The warp's 512-point ladder through the power, from the frame's windowed
// samples in registers (re[r] = sample first_sample(r)), with `row` as the
// exchange buffer: on return pw[k] holds the power of bin lane + 32k.
__device__ __forceinline__ void ladder_power(int (&re)[kPts], int* row,
                                             const int4* stw,
                                             int (&pw)[kBinsPerLane]) {
  const int l = lane();
  int im[kPts];
  // stages 0-3 on points 16l + r, the imaginary inputs 0
#pragma unroll
  for (int r = 0; r < kPts; ++r) im[r] = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int r = 0; r < kPts; ++r) {
      if (r & (1 << s)) continue;
      const int4 w = stw[(1 << s) - 1 + (r & ((1 << s) - 1))];
      butterfly(re[r], im[r], re[r + (1 << s)], im[r + (1 << s)], w);
    }
  }
#pragma unroll
  for (int r = 0; r < kPts; ++r) row[pad(16 * l + r)] = pack(re[r], im[r]);
  __syncwarp();

  // stages 4-7 on points b + 16k, b = 256(l >> 4) + (l & 15)
  const int b = ((l >> 4) << 8) + (l & 15);
#pragma unroll
  for (int k = 0; k < kPts; ++k) unpack(row[pad(b + 16 * k)], re[k], im[k]);
#pragma unroll
  for (int s = 4; s < 8; ++s) {
    const int q = s - 4;
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      if (k & (1 << q)) continue;
      const int4 w = stw[(1 << s) - 1 + (l & 15) + 16 * (k & ((1 << q) - 1))];
      butterfly(re[k], im[k], re[k + (1 << q)], im[k + (1 << q)], w);
    }
  }
  // every point a lane writes here it read above itself: no other lane's
  // read comes before it
#pragma unroll
  for (int k = 0; k < kPts; ++k) row[pad(b + 16 * k)] = pack(re[k], im[k]);
  __syncwarp();

  // stage 8 on points l + 32k: bins [0, 256) only, then their power
#pragma unroll
  for (int k = 0; k < kPts; ++k) unpack(row[pad(l + 32 * k)], re[k], im[k]);
#pragma unroll
  for (int k = 0; k < kBinsPerLane; ++k) {
    const int4 w = stw[kNbins - 1 + l + 32 * k];
    butterfly(re[k], im[k], re[k + kBinsPerLane], im[k + kBinsPerLane], w);
    pw[k] = power(re[k], im[k]);
  }
}

// Store the warp's power (ladder_power's pw) to row[k], natural bin order,
// once every lane of the warp has read the row.
__device__ __forceinline__ void store_power(int* row,
                                            const int (&pw)[kBinsPerLane]) {
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kBinsPerLane; ++k) row[lane() + 32 * k] = pw[k];
  __syncwarp();
}

// One lane's half of a DCT-ladder butterfly whose other point lies in lane
// lane ^ span: the lane of the lower point keeps y0, the other y1.  With
// `real`, both imaginary parts are known to be 0.
__device__ __forceinline__ void shfl_butterfly(int& vr, int& vi, int span,
                                               int4 w, bool real) {
  const int pr = __shfl_xor_sync(kFull, vr, span);
  const int pi = real ? 0 : __shfl_xor_sync(kFull, vi, span);
  const bool upper = (lane() & span) != 0;
  int x0r = upper ? pr : vr, x0i = upper ? pi : vi;
  int x1r = upper ? vr : pr, x1i = upper ? vi : pi;
  butterfly(x0r, x0i, x1r, x1i, w);
  vr = upper ? x1r : x0r;
  vi = upper ? x1i : x0i;
}

// The stages after the power for the warp's frame, whose power sits in
// pw[k], k < 256: the integer mel filterbank mod 2^64 over each filter's
// band, log2, and the DCT-II as a 4*nfilters-point INT FFT of the
// scattered log-mel row (buf[2k+1] = buf[4n-1-2k] = logmel[k],
// mfcc/core/dct_stream.py:29-34).  Lane c < ncep stores cepstrum c at
// out[c].  Needs load_tail_tables and a barrier after it.
__device__ __forceinline__ void post_power(const int* pw, const Smem& sm,
                                           const Tail& c, int* out) {
  const int l = lane();
  const int nf = c.nfilters;
  const int lpf = kLanes / nf;          // lanes per filter: 1 or 2
  const int j = l / lpf;
  const int2 bd = sm.band[j];
  const int cap = kFbTable / nf;
  unsigned long long acc = 0;
  for (int t = l - j * lpf; t < bd.y - bd.x; t += lpf) {
    const unsigned long long w = t < cap
        ? sm.fbt[t * nf + j]
        : static_cast<unsigned long long>(c.fbw[(bd.x + t) * nf + j]);
    acc += static_cast<unsigned long long>(static_cast<uint32_t>(pw[bd.x + t])) * w;
  }
  if (lpf == 2) acc += __shfl_xor_sync(kFull, acc, 1);
  const int mel = static_cast<int>(static_cast<long long>(acc) >> c.fb_shift) & kMelMask;
  const int logmel = log2fix(mel, c.log_precision, c.log_width);

  // DCT ladder: the upper half, points H + u (H = 2*nf), u = l + 32r
  const int log2h = nf == 32 ? 6 : 5;
  const int h = 1 << log2h;
  int vr[2], vi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    vr[r] = vi[r] = 0;
    if (r == 0 || nf == 32) {
      const int src = bitrev(h + l + 32 * r, log2h + 1);   // odd
      const int k = src < h ? (src - 1) >> 1 : (2 * h - 1 - src) >> 1;
      vr[r] = __shfl_sync(kFull, logmel, k * lpf);
    }
  }
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int4 w = sm.dtw[(l & ((1 << s) - 1)) << (log2h - s)];
    shfl_butterfly(vr[0], vi[0], 1 << s, w, s == 0);
    if (nf == 32) shfl_butterfly(vr[1], vi[1], 1 << s, w, s == 0);
  }
  if (nf == 32) {   // span 32: the lane's own two points
    const int4 w = sm.dtw[l << 1];
    butterfly(vr[0], vi[0], vr[1], vi[1], w);
  }
  // the last stage: x0 from the zero lower half, x1 the lane's point l
  int y0r = 0, y0i = 0;
  const int4 w = sm.dtw[l];
  butterfly(y0r, y0i, vr[0], vi[0], w);
  if (l < c.ncep) out[l] = y0r;
}

// The warp's frame through the ladder, the power and post_power, from its
// windowed samples in the ladder's first layout (re[r] = sample
// first_sample(r)), lane c storing cepstrum c at out[c].  Needs the tables
// and a barrier after them; ends with the warp's row free for its next
// frame.
__device__ __forceinline__ void tail(int (&re)[kPts], Smem& sm, const Tail& c,
                                     int* out) {
  int* row = sm.row + (threadIdx.x / kLanes) * kRow;
  int pw[kBinsPerLane];
  ladder_power(re, row, sm.stw, pw);
  store_power(row, pw);
  post_power(row, sm, c, out);
  __syncwarp();
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
