// Device functions of the float MFCC tail, in FP64: the packed nfft/2-point
// FFT, the real-spectrum unpack and power, the mel sum on the balanced
// schedule with floor and log2, and the DCT product with the f32 store.
// Shared by the FP64 tail's walk (fladder.cu: K1, K6, K1-Kaldi and K7
// from raw audio, K7-frames from frames), the float serving step K4
// (stream_step.cu, from carry and chunk) and, up to the log, SeamlessM4T's
// fbank walk K12 (seamless_fbank.cu, ladder_power and mel_log2).  Each has
// its own ingest: the warp loads its frame's packed points z[m] = y[2m] +
// i*y[2m+1] after the window * 1/nfft straight into registers, lane l
// holding z[l + 32r], and calls ladder_tail.  The tail is the same
// arithmetic in the same order for all of them, so their outputs agree bit
// for bit on the same frame values.
//
// Design: one warp owns one frame, a block of 8 warps 8 frames at a time,
// at every nfft; each warp runs its frame alone, with __syncwarp only:
//  * the M = nfft/2-point complex FFT in registers, P = M/32 points a lane
//    (4, 8, 16 at nfft 256, 512, 1024): radix-2 decimation in frequency on
//    the natural-order row, in passes of log2(P) stages (3+3+2 at nfft 512,
//    4+4+1 at 1024, 2+2+2+1 at 256).  In a pass whose register bits are [b,
//    b + log2 P) lane l's register r holds point (l mod 2^b) | r << b |
//    (l >> b) << (b + log2 P), so each stage pairs two registers of a lane;
//    between passes the warp exchanges through its row.  The twiddles of
//    stage t sit by stage, W_(2^(t+1))^j at (2^t - 1) + j, so a stage's
//    lanes read consecutive entries; stage 0's are 1 and skipped;
//  * the unpack reads Z[k] (at the bit-reversed position) and Z[M-k] from
//    the row, lane l taking the bin pairs (k, M - k) for k = l + 32u, and
//    |X|^2 goes to the row in natural bin order;
//  * the mel on the balanced schedule (see mel_log2 below): the bank's
//    nonzero terms cut evenly over the 32 lanes, each lane's segment sums
//    stored to slots in the row past the power, then lane j adds filter
//    j's slots, takes the floor and log2 and stores it where the power
//    was;
//  * the DCT one lane per cepstrum over the log-mel row, read as a
//    broadcast, with the dct column read through L1 (consecutive lanes,
//    consecutive words), and lane c's store of cepstrum c, coalesced; past
//    the last full round of 32 cepstra (ncep > 32: Kaldi's 40), the r left
//    are spread over groups of r lanes, each group a share of the filters,
//    joined by shuffles, so no lane takes two cepstra in turn.
// A frame's row holds M double2 with no pad: point i sits at slot(i) = i
// ^ swz(i), an XOR of its bits 0-2 with a fixed function of bits 3-8 that
// makes every access of the passes, the exchanges and the unpack free of
// bank conflicts at all three nfft (each 8-lane phase of a 16-byte access
// hits 8 distinct 16-byte slots of 128 bytes).  slot is linear in the
// bits, so slot(lane part | register part) costs one XOR.
//
// What bounds it now, at nfft 512: instruction issue (~730 FP64
// instructions a frame; the rest index and address work, shared loads and
// stores, loop control), beside ~500 shared-memory wavefronts a frame.
// Left for later: fewer index and address instructions; radix-4 passes
// (the -i rotation is free, ~10% fewer FP64 instructions).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace fladder_stages {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kFrames = kThreads / kLanes;   // frames per block, one a warp
constexpr int kMelPerPoint = 6;              // mel table doubles per point
// The mel schedule holds nfft/2 / kMelBinsPerStep steps a lane: a
// triangular bank has at most two terms a bin, 2 * nfft/2 over 32 lanes
constexpr int kMelBinsPerStep = 16;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int bitrev(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

__device__ __forceinline__ int lane() { return threadIdx.x & (kLanes - 1); }

// The row swizzle (see the notes above): bits 3..8 of i select XOR masks
// 2, 5, 6, 4, 1, 2 of bits 0-2.
__host__ __device__ constexpr int swz(int i) {
  return ((i >> 3 & 1) * 2) ^ ((i >> 4 & 1) * 5) ^ ((i >> 5 & 1) * 6) ^
         ((i >> 6 & 1) * 4) ^ ((i >> 7 & 1) * 1) ^ ((i >> 8 & 1) * 2);
}

__host__ __device__ constexpr int slot(int i) { return i ^ swz(i); }

// log2(nfft) for nfft 256, 512 or 1024, else -1.
inline int log2_nfft(int nfft) {
  return nfft == 256 ? 8 : nfft == 512 ? 9 : nfft == 1024 ? 10 : -1;
}

// Dynamic shared memory of one block (see Smem).
inline size_t smem_bytes(int nfft) {
  const size_t M = nfft / 2;
  return sizeof(double2) * (kFrames * M + 2 * M - 1) +
         sizeof(double) * kMelPerPoint * M;
}

// The mel schedule's steps a lane that the tail runs: msteps where the
// table holds them (1 to nfft/2 / kMelBinsPerStep), else 0, the
// lane-per-filter loop.  ops/fladder.py mel_steps_fit decides the same.
inline int mel_steps(const void* msched, int msteps, int nfft) {
  return msched && msteps >= 1 && msteps <= nfft / 2 / kMelBinsPerStep
             ? msteps : 0;
}

// Raise the kernel's dynamic shared-memory limit when the tile needs more
// than the default 48 KB; returns a cudaError_t.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// fn(std::integral_constant<int, LOG2P>()) for nfft's points per lane, P =
// 2^LOG2P = nfft/64; cudaErrorInvalidValue for another nfft.
template <typename Fn>
inline int with_points(int nfft, Fn fn) {
  switch (nfft) {
    case 256: return fn(std::integral_constant<int, 2>());
    case 512: return fn(std::integral_constant<int, 3>());
    case 1024: return fn(std::integral_constant<int, 4>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The block's shared arrays, carved from the dynamic shared memory.
struct Smem {
  double2* buf;     // kFrames rows of M points at slot(m), the warps'
                    // exchanges; later each holds its frame's power (M
                    // doubles), the mel segments' slots and log-mel row
  double2* stw;     // M twiddles W^k = exp(-2 pi i k / nfft), the unpack's
  double2* ftw;     // M - 1 FFT twiddles by stage (see the notes above)
  // The mel table, kMelPerPoint * M doubles, holds one of two layouts:
  double2* msched;  // the schedule's entries, msteps * 32 (mel_log2; at
                    // most 2M double2), then
  unsigned* mgather;  // its gather words, one a filter (at most M);
  double* melt;     // or, without a schedule, the weights by band offset
                    // (melt[t * nfilters + m] = mel[lo_m + t, m])
  int R;            // row stride, M
  int msteps;       // the schedule's steps a lane; 0: a lane per filter
};

// The block's arrays, for a mel schedule of msteps steps a lane (mel_steps:
// 0 for none).
__device__ __forceinline__ Smem carve(double2* smem, int log2n, int msteps) {
  const int M = 1 << (log2n - 1);
  Smem sm;
  sm.R = M;
  sm.msteps = msteps;
  sm.buf = smem;
  sm.stw = sm.buf + kFrames * M;
  sm.ftw = sm.stw + M;
  sm.msched = sm.ftw + (M - 1);
  sm.mgather = reinterpret_cast<unsigned*>(
      sm.msched + kLanes * (M / kMelBinsPerStep));
  sm.melt = reinterpret_cast<double*>(sm.msched);
  return sm;
}

// Fill the twiddle and mel tables from the nfft/2 twiddles W^k and either
// the mel schedule (ops/fladder.py mel_schedule: sm.msteps * 32 entries,
// then nfilters gather words) or, without one, the (M, nfilters) mel and
// its band limits, in global memory; the caller's barrier follows.
__device__ __forceinline__ void load_constants(const Smem& sm, int log2n,
                                               const double2* tw,
                                               const double* mel,
                                               const int2* band,
                                               const double2* msched,
                                               int nfilters) {
  const int log2m = log2n - 1;
  const int M = 1 << log2m;
  for (int i = threadIdx.x; i < M; i += blockDim.x) sm.stw[i] = tw[i];
  for (int i = threadIdx.x; i < M - 1; i += blockDim.x) {
    const int t = 31 - __clz(i + 1);
    sm.ftw[i] = tw[(i + 1 - (1 << t)) << (log2m - t)];
  }
  if (sm.msteps == 0) {
    const int n = kMelPerPoint * M / nfilters * nfilters;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int t = e / nfilters;
      const int m = e - t * nfilters;
      const int2 bd = band[m];
      sm.melt[e] = bd.x + t < bd.y ? mel[(bd.x + t) * nfilters + m] : 0.0;
    }
    return;
  }
  const int n = sm.msteps * kLanes;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sm.msched[i] = msched[i];
  const unsigned* gather = reinterpret_cast<const unsigned*>(msched + n);
  for (int i = threadIdx.x; i < nfilters; i += blockDim.x)
    sm.mgather[i] = gather[i];
}

// The packed point z = (ye * w.x, yo * w.y) of emphasized samples ye, yo and
// the window pair w, each product rounded once as a stored value would be:
// left to the compiler, a product may fuse into the first FFT stage's add
// in one kernel and not in another, and the kernels on this tail must
// agree bit for bit on the same samples.
__device__ __forceinline__ double2 window_pair(double ye, double yo, double2 w) {
  return make_double2(__dmul_rn(ye, w.x), __dmul_rn(yo, w.y));
}

// Kaldi's ingest (fladder.cu's KaldiIngest; the recipe of
// config.KaldiConfig, kaldi-asr/kaldi src/feat/feature-window.cc): the
// warp's frame of L = wlen raw samples x_0..x_(L-1) (wlen even, at most
// nfft), its packed points z[m] = y'[2m] + i*y'[2m+1] in registers as the
// tail takes them, lane l's register r holding z[l + 32r], and nothing read
// past x_(L-1).  Kaldi computes, per frame:
//   w_i = x_i - mu, mu = (x_0 + ... + x_(L-1)) / L        (DC offset)
//   y_i = w_i - c*w_(i-1) for i >= 1, y_0 = w_0 - c*w_0   (pre-emphasis)
//   y'_i = y_i * povey_i, zero for i >= L                  (window, padding)
// with no 1/nfft.  Substituting w into y:
//   y_i = x_i - c*x_(i-1) - (1 - c)*mu for i >= 1, and
//   y_0 = (1 - c)*(x_0 - mu) = x_0 - c*x_0 - (1 - c)*mu,
// which is the i >= 1 form with x_(-1) taken as x_0.  So a lane emphasizes
// its samples as it loads them, e_i = x_i - c*x_(i-1), and sums them; the
// warp's sum gives mu once every lane has loaded; and y_i = e_i - d with d
// = (1 - c)*mu, the same for every sample: the two corrections are the one
// subtraction and x_0 in place of the missing x_(-1).  The window product
// rounds once, as window_pair does for the other ingests.  Points m with
// 2m >= L are the padding: zero, and never loaded.
template <int LOG2P, typename In>
__device__ __forceinline__ void kaldi_ingest(const In* __restrict__ x,
                                             int wlen, double c,
                                             const double2* __restrict__ win,
                                             double2 (&z)[1 << LOG2P]) {
  constexpr int kP = 1 << LOG2P;
  const int l = lane();
  double sum = 0.0;
#pragma unroll
  for (int r = 0; r < kP; ++r) {
    const int m = l + 32 * r;
    z[r] = make_double2(0.0, 0.0);
    if (2 * m < wlen) {
      const double p = static_cast<double>(x[m > 0 ? 2 * m - 1 : 0]);
      const double a = static_cast<double>(x[2 * m]);
      const double b = static_cast<double>(x[2 * m + 1]);
      sum += a + b;
      z[r] = make_double2(a - c * p, b - c * a);
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const double d = (1.0 - c) * (sum / wlen);
#pragma unroll
  for (int r = 0; r < kP; ++r) {
    const int m = l + 32 * r;
    if (2 * m < wlen) z[r] = window_pair(z[r].x - d, z[r].y - d, win[m]);
  }
}

// The lane part of the points of the layout with register bits [b, b +
// LOG2P): point(l, r) = lane_part(l) | r << b.
template <int LOG2P>
__device__ __forceinline__ int lane_part(int l, int b) {
  return (l & ((1 << b) - 1)) | ((l >> b) << (b + LOG2P));
}

// Pass PASS of the warp's M-point DIF FFT (M = 2^(5 + LOG2P)): stages
// [b, hi) on the layout with register bits [b, b + LOG2P), then the next
// pass.  The first pass starts from x[r] = z[lane + 32r]; the exchanges go
// through `row`; on return x[r] holds Z[bitrev(r | lane << LOG2P)].
template <int LOG2P, int PASS>
__device__ __forceinline__ void fft_pass(double2 (&x)[1 << LOG2P],
                                         double2* row, const double2* ftw) {
  constexpr int kP = 1 << LOG2P;
  constexpr int hi = 5 + LOG2P - LOG2P * PASS;
  constexpr int b = hi > LOG2P ? hi - LOG2P : 0;
  const int l = lane();
  if constexpr (PASS > 0) {
    // back to the row in the last pass's layout (base hi); every slot a
    // lane writes it read itself
    const int was = slot(lane_part<LOG2P>(l, hi));
#pragma unroll
    for (int r = 0; r < kP; ++r) row[was ^ slot(r << hi)] = x[r];
    __syncwarp();
  }
  if constexpr (PASS > 0) {
    const int at = slot(lane_part<LOG2P>(l, b));
#pragma unroll
    for (int r = 0; r < kP; ++r) x[r] = row[at ^ slot(r << b)];
  }
#pragma unroll
  for (int t = hi - 1; t >= b; --t) {
    const int q = t - b;
#pragma unroll
    for (int r = 0; r < kP; ++r) {
      if (r & (1 << q)) continue;
      const double2 a = x[r], c = x[r + (1 << q)];
      const double2 d = make_double2(a.x - c.x, a.y - c.y);
      x[r] = make_double2(a.x + c.x, a.y + c.y);
      if (t == 0) {
        x[r + (1 << q)] = d;
      } else {
        const int j = (l & ((1 << b) - 1)) | ((r & ((1 << q) - 1)) << b);
        x[r + (1 << q)] = cmul(d, ftw[(1 << t) - 1 + j]);
      }
    }
  }
  if constexpr (b > 0) fft_pass<LOG2P, PASS + 1>(x, row, ftw);
}

// |X[k]|^2 of the real frame from Z[k], Z[M-k] and W^k:
// X[k] = (Z[k] + conj Z[M-k])/2 + W^k (Z[k] - conj Z[M-k])/2i.
__device__ __forceinline__ double bin_power(double2 zk, double2 zn, double2 w) {
  const double2 xe = make_double2(0.5 * (zk.x + zn.x), 0.5 * (zk.y - zn.y));
  const double2 xo = make_double2(0.5 * (zk.y + zn.y), -0.5 * (zk.x - zn.x));
  const double2 wx = cmul(xo, w);
  const double re = xe.x + wx.x, im = xe.y + wx.y;
  return re * re + im * im;
}

// The mel sums of the warp's power row pw (M doubles), their floor and
// log2, to the log-mel row, lane j storing its filter j; returns the row.
//
// On the balanced schedule (sm.msteps > 0; built on the host by
// ops/fladder.py mel_schedule): a lane per filter would run the widest
// band's length while most lanes idle (38 bins for an average of 13 at 32
// filters of nfft 512; at Kaldi's 40 filters a second pass on 8 lanes).
// Instead the bank's nonzero (filter, bin) terms, filter-major with bins
// ascending, are cut into 32 runs of L = msteps = ceil(terms / 32) (14 for
// the FPGA bank, 15 for Kaldi's), lane l taking run l.  Entry i of lane l,
// at i*32 + l (consecutive lanes on consecutive 16 bytes), is {weight,
// offsets}: the FP64 weight, and in the other 8 bytes the byte offset of
// the term's power in the row (low word) and 0 or, at the last term of a
// segment (a run's stretch of one filter), the byte offset of the
// segment's slot in the row's second half, past the power (high word).
// The lane stores its sum there and starts the next segment's from 0:
// every segment sums its own non-negative terms in bin order, never a
// difference of running sums (in FP64 that would cancel where a loud
// filter precedes a quiet one in a lane; band sums span FLT_EPSILON to
// ~1e14 here).  After a __syncwarp the power is spent: lane j adds filter
// j's slots, consecutive and in bin order (mgather[j] holds the first
// one's byte offset and their count << 16: at most 4 in the FPGA bank, 3
// in Kaldi's), and stores its log-mel at pw[j].  The slots, at most
// nfilters + 31, have the row's M doubles past the power.  A filter
// inside one segment is summed as a lane per filter sums it, bit for bit;
// a split one moves by a few FP64 ulp.  Padding entries are 0 (weight 0
// on bin 0, no store).
//
// The loop is unrolled to the table's capacity, kCap = M / kMelBinsPerStep
// steps, and leaves at msteps by a uniform branch: with no counter, stride
// or remainder to keep, K1 ran ~2% faster than on a loop unrolled by 2,
// and without its 16-byte spill (one-process A/B, H100).
//
// Without a schedule (msteps 0: none given, or a bank over the table's
// capacity or the row's) a lane per filter sums its band [lo, hi), the
// weights from the block's melt table and past its rows from mel in
// global memory, to the log-mel row pw + M.
template <int kCap>
__device__ __forceinline__ double* mel_log2(double* pw, const Smem& sm,
                                            int nfilters,
                                            const double* __restrict__ mel,
                                            const int2* __restrict__ band,
                                            double mel_floor) {
  const int l = lane();
  char* rb = reinterpret_cast<char*>(pw);
  double* lm = sm.msteps ? pw : pw + sm.R;
  if (sm.msteps) {
    const double2* e = sm.msched + l;
    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < kCap; ++i) {
      if (i == sm.msteps) break;
      const double2 t = e[i * kLanes];
      const long long o = __double_as_longlong(t.y);
      acc = fma(*reinterpret_cast<const double*>(rb + static_cast<int>(o)),
                t.x, acc);
      const int slot_at = static_cast<int>(o >> 32);
      if (slot_at) *reinterpret_cast<double*>(rb + slot_at) = acc;
      acc = slot_at ? 0.0 : acc;
    }
    __syncwarp();
  }
  const int rows = sm.msteps ? 0 : kMelPerPoint * sm.R / nfilters;
  for (int m = l; m < nfilters; m += kLanes) {
    double acc = 0.0;
    if (sm.msteps) {
      const unsigned g = sm.mgather[m];
      const double* s = reinterpret_cast<const double*>(rb + (g & 0xFFFF));
      for (unsigned k = 0; k < g >> 16; ++k) acc += s[k];
    } else {
      const int2 bd = band[m];
      for (int t = 0; t < bd.y - bd.x; ++t) {
        const double w = t < rows ? sm.melt[t * nfilters + m]
                                  : mel[(bd.x + t) * nfilters + m];
        acc = fma(pw[bd.x + t], w, acc);
      }
    }
    if (mel_floor != 0.0) acc = fmax(acc, mel_floor);
    lm[m] = log2(acc);
  }
  return lm;
}

// The DCT of the log-mel row lm, read as a broadcast, lane c storing
// cepstrum c at out[c]: a lane a cepstrum over every filter, in rounds of
// 32.  Where ncep > 32 is not a multiple of 32 (Kaldi's 40), the r = ncep
// mod 32 cepstra past the last full round are spread over groups of r
// lanes (4 groups of 8 at r = 8), group g summing filters [g*share, (g+1)*
// share), then log2(groups) shuffles join the groups and lanes 0..r-1
// store: 40 + 10 steps at 40 x 40 where a second round on 8 lanes took 80.
// A uniform branch on ncep; at ncep <= 32 only the first loop runs.
__device__ __forceinline__ void dct_out(const double* lm, int nfilters,
                                        int ncep,
                                        const double* __restrict__ dct,
                                        float* __restrict__ out) {
  const int l = lane();
  const int full = ncep > kLanes ? ncep & -kLanes : ncep;
  for (int c = l; c < full; c += kLanes) {
    double acc = 0.0;
    for (int m = 0; m < nfilters; ++m) acc = fma(lm[m], dct[m * ncep + c], acc);
    out[c] = static_cast<float>(acc);
  }
  if (full == ncep) return;
  const int r = ncep - full;
  int groups = 1;
  while (2 * groups * r <= kLanes) groups *= 2;
  const int g = l / r;
  const int c = full + l - g * r;
  const int share = (nfilters + groups - 1) / groups;
  double acc = 0.0;
  if (g < groups) {
    const int m1 = min(nfilters, (g + 1) * share);
    for (int m = g * share; m < m1; ++m)
      acc = fma(lm[m], dct[m * ncep + c], acc);
  }
  for (int h = groups / 2; h > 0; h /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, h * r);
  if (l < r) out[c] = static_cast<float>(acc);
}

// The warp's frame through the FFT and |X|^2, from its packed points in
// registers, x[r] = z[lane + 32r], to the power of bins [0, M) in natural
// order at the start of the warp's row, its exchange buffer; returns the
// row.  Needs load_constants and a barrier after it.
template <int LOG2P>
__device__ __forceinline__ double* ladder_power(double2 (&x)[1 << LOG2P],
                                                const Smem& sm) {
  constexpr int kP = 1 << LOG2P;
  constexpr int kLog2M = 5 + LOG2P;
  constexpr int M = 1 << kLog2M;
  const int l = lane();
  double2* row = sm.buf + (threadIdx.x / kLanes) * sm.R;

  fft_pass<LOG2P, 0>(x, row, sm.ftw);
  const int at = slot(lane_part<LOG2P>(l, 0));
#pragma unroll
  for (int r = 0; r < kP; ++r) row[at ^ slot(r)] = x[r];
  __syncwarp();

  // bins k = l + 32u and M - k (M/2 for k = 0)
  double pk[kP / 2], pn[kP / 2];
#pragma unroll
  for (int u = 0; u < kP / 2; ++u) {
    const int k = l + 32 * u;
    const int k2 = k ? M - k : M / 2;
    const double2 zk = row[slot(bitrev(k, kLog2M))];
    const double2 z2 = row[slot(bitrev(k2, kLog2M))];
    pk[u] = bin_power(zk, k ? z2 : zk, sm.stw[k]);
    pn[u] = bin_power(z2, k ? zk : z2, sm.stw[k2]);
  }
  __syncwarp();
  double* pw = reinterpret_cast<double*>(row);
#pragma unroll
  for (int u = 0; u < kP / 2; ++u) {
    const int k = l + 32 * u;
    pw[k] = pk[u];
    pw[k ? M - k : M / 2] = pn[u];
  }
  __syncwarp();
  return pw;
}

// The warp's frame through the FFT, |X|^2, mel, floor, log2 and the DCT,
// from its packed points in registers, x[r] = z[lane + 32r], lane c
// storing cepstrum c at out[c] (out points at the frame's ncep outputs).
// Needs load_constants and a barrier after it.
template <int LOG2P>
__device__ __forceinline__ void ladder_tail(double2 (&x)[1 << LOG2P],
                                            const Smem& sm, int nfilters,
                                            int ncep,
                                            const double* __restrict__ mel,
                                            const double* __restrict__ dct,
                                            const int2* __restrict__ band,
                                            double mel_floor,
                                            float* __restrict__ out) {
  constexpr int M = 1 << (5 + LOG2P);
  double* pw = ladder_power<LOG2P>(x, sm);
  const double* lm = mel_log2<M / kMelBinsPerStep>(pw, sm, nfilters, mel,
                                                   band, mel_floor);
  __syncwarp();
  dct_out(lm, nfilters, ncep, dct, out);
  __syncwarp();   // the row is free for the warp's next frame
}

}  // namespace fladder_stages
