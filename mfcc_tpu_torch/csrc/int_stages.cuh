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
// r) (32 consecutive samples across the lanes), and calls tail_balanced();
// the block's one barrier is the one after its tables.  From there each
// warp runs alone, with __syncwarp only:
//  * the 512-point radix-2 DIT ladder in registers, 16 points a lane: lane
//    l holds points 16l + r for stages 0-3 (spans 1-8, the first with its
//    zero imaginary inputs folded by the compiler), exchanges through its
//    row for points 256(l>>4) + (l&15) + 16k for stages 4-7, and once more
//    for points l + 32k for stage 8, of which only the outputs of bins
//    [0, 256) are computed.  An exchange packs each 16-bit (re, im) pair
//    into one word (every ladder value is a wrap16 output) and is free of
//    bank conflicts but for one lane pair of the second;
//  * the power of bins l + 32k in registers, stored to the row in natural
//    order; the balanced filterbank: the bank's nonzero (filter, bin) terms
//    split evenly over the 32 lanes by a schedule built on the host
//    (below), then log2 a lane per filter;
//  * the 4*nfilters-point DCT ladder in registers: its lower half is zero
//    through every stage but the last (bit-reversed storage puts the
//    scattered log-mel row's odd points in the upper half), so the upper
//    half's 2*nfilters points run one or two a lane, pairs across lanes by
//    shuffles, and lane c takes the last stage's real output c: cepstrum
//    c, stored by lane c (one coalesced store a frame).
// The butterfly is the RTL's datapath, unchanged; only data movement and
// schedule are the kernel's.  What bounds it now is instruction issue
// (int_mfcc.cu).  Left for later: fewer instructions per butterfly and per
// exchange.

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

// Constants of the stages after the 512-point FFT (device pointers).
struct Tail {
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

// The ladder's twiddle table from the 256 twiddles of twiddle_table(512,
// 16) in global memory, as butterfly() takes them: stage s at (2^s - 1) +
// j, twiddle_table(512, 16)[j << (8 - s)], so that the lanes of a stage
// read consecutive entries.  The caller's barrier follows.
template <typename S>
__device__ __forceinline__ void load_ladder_tables(S& sm, const int2* tw) {
  for (int i = threadIdx.x; i < kNfft - 1; i += blockDim.x) {
    const int s = 31 - __clz(i + 1);
    sm.stw[i] = twiddle(tw[(i + 1 - (1 << s)) << (kLog2Nfft - 1 - s)]);
  }
}

// The sample lane l's register r holds in the ladder's first layout: point
// 16l + r of the bit-reversed load is sample bitrev(16l + r).  For a fixed
// r the 32 lanes read 32 consecutive samples.
__device__ __forceinline__ int first_sample(int r) {
  return bitrev(16 * lane() + r, kLog2Nfft);
}

// r's 4 bits reversed (r < 16): first_sample(r) = bitrev(lane, 5) + 32 *
// rev4(r), one base a lane and constant offsets.
__host__ __device__ constexpr int rev4(int r) {
  return ((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) | ((r & 8) >> 3);
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
// first_sample(r) = bitrev(lane, 5) + 32 * rev4(r): one base a lane and
// constant offsets.  curve: int (global memory) or volatile int (shared
// memory, read anew each frame).
template <typename In, typename Curve>
__device__ __forceinline__ void load_audio_frame(const In* x, bool first,
                                                 const Curve* curve,
                                                 int (&re)[kPts]) {
  const int b = bitrev(lane(), 5);
  x += b;
  curve += b;
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    const int q = 32 * rev4(r);
    const int prev = r == 0 && first && b == 0 ? 0 : x[q - 1];
    re[r] = window(emphasize<In>(x[q], prev), curve[q]);
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

// The stages after the filterbank for the warp's frame: lane l holds the
// uint64 filterbank sum (mod 2^64) of filter l / lpf in acc (lpf, lanes a
// filter, is 1 on the balanced filterbank); the 16-bit
// field at fb_shift, log2, and the DCT-II as a 4*nfilters-point INT FFT of
// the scattered log-mel row (buf[2k+1] = buf[4n-1-2k] = logmel[k],
// mfcc/core/dct_stream.py:29-34).  Lane c < ncep stores cepstrum c at
// out[c].  dtw: the DCT's twiddles as butterfly() takes them.
__device__ __forceinline__ void log_dct(unsigned long long acc, int lpf,
                                        const int4* dtw, const Tail& c,
                                        int* out) {
  const int l = lane();
  const int nf = c.nfilters;
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
    const int4 w = dtw[(l & ((1 << s) - 1)) << (log2h - s)];
    shfl_butterfly(vr[0], vi[0], 1 << s, w, s == 0);
    if (nf == 32) shfl_butterfly(vr[1], vi[1], 1 << s, w, s == 0);
  }
  if (nf == 32) {   // span 32: the lane's own two points
    const int4 w = dtw[l << 1];
    butterfly(vr[0], vi[0], vr[1], vi[1], w);
  }
  // the last stage: x0 from the zero lower half, x1 the lane's point l
  int y0r = 0, y0i = 0;
  const int4 w = dtw[l];
  butterfly(y0r, y0i, vr[0], vi[0], w);
  if (l < c.ncep) out[l] = y0r;
}

// -- The balanced filterbank (K2, K3, K4-INT, K10's epilogue) ---------------
//
// A lane per filter over its band would run the widest band's length while
// most lanes idle (37 bins at 32 filters for an average of 13; 70 at 16
// filters, two lanes a filter).  Here the bank's nonzero (filter, bin) terms, in
// filter order and ascending bins, are cut into 32 runs of L = ceil(terms /
// 32) (14 at both 32 and 16 filters of the 512-point family), lane l
// taking run l, so a lane's run covers consecutive filters.  The schedule is
// built on the host (ops/int_fused.py fb_schedule), kFbSteps entries a
// lane, zero-padded: every in-family bank has at most 512 terms (a bin
// feeds at most two triangular filters), so 16 steps hold any of them and
// the loop unrolls whole.  Entry i of lane l, at i*32 + l (consecutive
// lanes on consecutive 8-byte words), is {weight, offsets}: the weight as
// uint32 (in the family the weights are at most 2^power_width = 2^30) and
// two byte offsets in the warp's row, the term's power word (4 * bin) in
// the low 16 bits and, in the high 16 bits, 0 or, at the last term of a
// segment (a run's stretch of one filter), the segment's uint64 slot past
// the power (kSlotBase on).  The lane's sum runs over its whole run mod
// 2^64 and is stored to the slot at each segment's end (a predicated store:
// storing at every term, to a scratch slot, cost more shared-memory
// bandwidth than the predicate saves in instructions).  A segment's sum is
// its slot less the slot before it where that is the same lane's, which
// only a filter's first segment can follow.  After a __syncwarp lane j
// adds filter j's slots, which are consecutive: gather[j] holds the first
// one's byte offset, their count in bits 16-30 and in bit 31 whether the
// slot before the first is subtracted (0 for a lane past the filters).
// Every sum is mod 2^64, so any order or split of the terms gives the
// lane-per-filter sum's bits exactly.
constexpr int kFbSteps = 16;              // schedule entries a lane
constexpr int kSlotBase = kNbins * 4;     // the slots' first byte in a row

struct FbTables {
  uint2 sched[kFbSteps * kLanes];
  unsigned gather[kLanes];
  int4 dtw[2 * kMaxFilters];
};

// K10's epilogue's shared memory: the warps' rows (the exchanges at pad(i)
// = i + i/16, which spreads them over the banks; then the power and the
// slots) and the tables.  K2's, K3's and K4-INT's add the ladder's
// twiddles and the window curve (K10's front uses its rows and twiddles).
struct FbSmem {
  int row[kFrames * kRow];
  FbTables fb;
};

struct FbLadderSmem {
  int row[kFrames * kRow];
  int4 stw[kNfft - 1];
  int curve[kNfft];
  FbTables fb;
};

// The balanced filterbank's tables from the schedule in global memory
// (kFbSteps * 32 entries, then the 32 gather words) and the DCT's
// twiddles; the caller's barrier follows.
__device__ __forceinline__ void load_fb_tables(FbTables& fb, const uint2* sched,
                                               const Tail& c) {
  for (int i = threadIdx.x; i < 2 * c.nfilters; i += blockDim.x)
    fb.dtw[i] = twiddle(c.dtw[i]);
  for (int i = threadIdx.x; i < kFbSteps * kLanes; i += blockDim.x)
    fb.sched[i] = sched[i];
  const unsigned* gather = reinterpret_cast<const unsigned*>(sched + kFbSteps * kLanes);
  for (int i = threadIdx.x; i < kLanes; i += blockDim.x) fb.gather[i] = gather[i];
}

// The stages after the power on the balanced filterbank, then log_dct: the
// warp's power in row[k], k < 256, its slots in the same row past it (the ladder's exchanges are done
// with both by now).  Needs load_fb_tables and a barrier after it.
__device__ __forceinline__ void post_power_balanced(int* row, const FbTables& fb,
                                                    const Tail& c, int* out) {
  const int l = lane();
  char* rb = reinterpret_cast<char*>(row);
  unsigned long long acc = 0;
#pragma unroll
  for (int i = 0; i < kFbSteps; ++i) {
    const uint2 e = fb.sched[i * kLanes + l];
    const uint32_t p = *reinterpret_cast<const uint32_t*>(rb + (e.y & 0xFFFF));
    acc += static_cast<unsigned long long>(p) * e.x;
    if (e.y >> 16) *reinterpret_cast<unsigned long long*>(rb + (e.y >> 16)) = acc;
  }
  __syncwarp();
  const unsigned g = fb.gather[l];
  const unsigned long long* s =
      reinterpret_cast<const unsigned long long*>(rb + (g & 0xFFFF));
  acc = g >> 31 ? 0ull - s[-1] : 0ull;
#pragma unroll 1
  for (unsigned k = 0; k < ((g >> 16) & 0x7FFF); ++k) acc += s[k];  // <= 6
  log_dct(acc, 1, fb.dtw, c, out);
}

// The warp's frame through the ladder, the power and post_power_balanced,
// from its windowed samples in the ladder's first layout (re[r] = sample
// first_sample(r)), lane c storing cepstrum c at out[c] (K2, K3, K4-INT).
// Needs load_ladder_tables, load_fb_tables and a barrier after them; ends
// with the warp's row free for its next frame.
__device__ __forceinline__ void tail_balanced(int (&re)[kPts], FbLadderSmem& sm,
                                              const Tail& c, int* out) {
  int* row = sm.row + (threadIdx.x / kLanes) * kRow;
  int pw[kBinsPerLane];
  ladder_power(re, row, sm.stw, pw);
  store_power(row, pw);
  post_power_balanced(row, sm.fb, c, out);
  __syncwarp();
}

inline bool tail_ok(const Tail& c) {
  return (c.nfilters == 16 || c.nfilters == 32) && c.ncep >= 1 &&
         c.ncep <= c.nfilters && c.fb_shift >= 0 && c.fb_shift < 64 &&
         c.log_precision >= 1 && c.log_precision <= 15 &&
         c.log_width >= 1 && c.log_width <= 31;
}

inline Tail make_tail(const int* dtw, int nfilters, int ncep, int fb_shift,
                      int log_precision, int log_width) {
  return Tail{reinterpret_cast<const int2*>(dtw), nfilters, ncep, fb_shift,
              log_precision, log_width};
}

}  // namespace int_stages
