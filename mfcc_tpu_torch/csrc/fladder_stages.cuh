// Device functions of the float MFCC tail, in FP64: the packed nfft/2-point
// FFT, the real-spectrum unpack and power, the banded mel sum with floor and
// log2, and the DCT product with the f32 store.  Shared by K1 and K6
// (fladder.cu, from raw audio), K7 and K7-frames (f64ish.cu) and the float
// serving step K4 (stream_step.cu, from carry and chunk).  Each kernel has
// its own ingest: the warp loads its frame's packed points z[m] = y[2m] +
// i*y[2m+1] after the window * 1/nfft straight into registers, lane l
// holding z[l + 32r], and calls ladder_tail.  The tail is the same
// arithmetic in the same order for all of them, so their outputs agree bit
// for bit on the same frame values.  K8 (dense_dft.cu)
// shares mel_log2 and dct_store, functions of its own tile geometry that
// the tail does not use.
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
//  * the mel sums one lane per filter over its band, the weights read by
//    band offset from a block table (melt[t * nfilters + m] = mel[lo_m +
//    t, m], 6*M entries; rows past the table read global memory), the
//    floor and log2 in the same lane, the log-mel row after the power;
//  * the DCT one lane per cepstrum over the log-mel row, read as a
//    broadcast, with the dct column read through L1 (consecutive lanes,
//    consecutive words), and lane c's store of cepstrum c, coalesced.
// A frame's row holds M double2 with no pad: point i sits at slot(i) = i
// ^ swz(i), an XOR of its bits 0-2 with a fixed function of bits 3-8 that
// makes every access of the passes, the exchanges and the unpack free of
// bank conflicts at all three nfft (each 8-lane phase of a 16-byte access
// hits 8 distinct 16-byte slots of 128 bytes).  slot is linear in the
// bits, so slot(lane part | register part) costs one XOR.
//
// What bounds it now, at nfft 512: instruction issue, ~2.9k SASS
// instructions a warp per frame (~730 of them FP64; the rest index and
// address work, shared loads and stores, loop control), beside ~500
// shared-memory wavefronts a frame.  Left for later: fewer index and
// address instructions; the mel loop, whose widest band (38 bins) sets its
// length for an average of 13 and whose power reads conflict; radix-4
// passes (the -i rotation is free, ~10% fewer FP64 instructions).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace fladder_stages {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kFrames = kThreads / kLanes;   // frames per block, one a warp
constexpr int kMelPerPoint = 6;              // mel table entries per point

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
                    // doubles) and log-mel row
  double2* stw;     // M twiddles W^k = exp(-2 pi i k / nfft), the unpack's
  double2* ftw;     // M - 1 FFT twiddles by stage (see the notes above)
  double* melt;     // kMelPerPoint * M mel weights by band offset
  int R;            // row stride, M
};

__device__ __forceinline__ Smem carve(double2* smem, int log2n) {
  const int M = 1 << (log2n - 1);
  Smem sm;
  sm.R = M;
  sm.buf = smem;
  sm.stw = sm.buf + kFrames * M;
  sm.ftw = sm.stw + M;
  sm.melt = reinterpret_cast<double*>(sm.ftw + (M - 1));
  return sm;
}

// Fill the twiddle and mel tables from the nfft/2 twiddles W^k, the (M,
// nfilters) mel and its band limits in global memory; the caller's barrier
// follows.
__device__ __forceinline__ void load_constants(const Smem& sm, int log2n,
                                               const double2* tw,
                                               const double* mel,
                                               const int2* band,
                                               int nfilters) {
  const int log2m = log2n - 1;
  const int M = 1 << log2m;
  for (int i = threadIdx.x; i < M; i += blockDim.x) sm.stw[i] = tw[i];
  for (int i = threadIdx.x; i < M - 1; i += blockDim.x) {
    const int t = 31 - __clz(i + 1);
    sm.ftw[i] = tw[(i + 1 - (1 << t)) << (log2m - t)];
  }
  const int n = kMelPerPoint * M / nfilters * nfilters;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int t = e / nfilters;
    const int m = e - t * nfilters;
    const int2 bd = band[m];
    sm.melt[e] = bd.x + t < bd.y ? mel[(bd.x + t) * nfilters + m] : 0.0;
  }
}

// The mel product of FT power rows (row f at power + f * nbins) over each
// filter's band [lo, hi) of `band` ((nbins, nfilters) row-major mel), the
// optional floor and log2, into logmel[f * nfilters + m].  K8's
// (dense_dft.cu).
__device__ __forceinline__ void mel_log2(const double* power, int FT,
                                         int nbins, int nfilters,
                                         const int2* band,
                                         const double* __restrict__ mel,
                                         double mel_floor, double* logmel) {
  for (int o = threadIdx.x; o < FT * nfilters; o += blockDim.x) {
    const int f = o / nfilters;
    const int m = o - f * nfilters;
    const double* p = power + f * nbins;
    const int2 bd = band[m];
    double acc = 0.0;
    for (int k = bd.x; k < bd.y; ++k) acc = fma(p[k], mel[k * nfilters + m], acc);
    if (mel_floor != 0.0) acc = fmax(acc, mel_floor);
    logmel[o] = log2(acc);
  }
}

// The DCT product ((nfilters, ncep) row-major) of FT log-mel rows (row f at
// logmel + f * nfilters) and the store of frames f0 + f < F at
// out[(f0 + f) * ncep + c], rounded to f32 once.  K8's (dense_dft.cu).
__device__ __forceinline__ void dct_store(const double* logmel, int FT,
                                          int nfilters, int ncep,
                                          const double* __restrict__ dct,
                                          float* __restrict__ out, int f0,
                                          int F) {
  for (int o = threadIdx.x; o < FT * ncep; o += blockDim.x) {
    const int f = o / ncep;
    const int c = o - f * ncep;
    const int g = f0 + f;
    if (g >= F) continue;
    const double* lm = logmel + f * nfilters;
    double acc = 0.0;
    for (int m = 0; m < nfilters; ++m) acc = fma(lm[m], dct[m * ncep + c], acc);
    out[static_cast<long long>(g) * ncep + c] = static_cast<float>(acc);
  }
}

// The packed point z = (ye * w.x, yo * w.y) of emphasized samples ye, yo and
// the window pair w, each product rounded once as a stored value would be:
// left to the compiler, a product may fuse into the first FFT stage's add
// in one kernel and not in another, and the kernels on this tail must
// agree bit for bit on the same samples.
__device__ __forceinline__ double2 window_pair(double ye, double yo, double2 w) {
  return make_double2(__dmul_rn(ye, w.x), __dmul_rn(yo, w.y));
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

// The warp's frame through the FFT, |X|^2, mel, floor, log2 and the DCT,
// from its packed points in registers, x[r] = z[lane + 32r], lane c
// storing cepstrum c at out[c] (out points at the frame's ncep outputs).
// The warp's row is its exchange buffer.  Needs load_constants and a
// barrier after it.
template <int LOG2P>
__device__ __forceinline__ void ladder_tail(double2 (&x)[1 << LOG2P],
                                            const Smem& sm, int nfilters,
                                            int ncep,
                                            const double* __restrict__ mel,
                                            const double* __restrict__ dct,
                                            const int2* __restrict__ band,
                                            double mel_floor,
                                            float* __restrict__ out) {
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

  // mel over each band, floor, log2; the log-mel row after the power
  double* lm = pw + M;
  const int rows = kMelPerPoint * M / nfilters;
  for (int m = l; m < nfilters; m += kLanes) {
    const int2 bd = band[m];
    double acc = 0.0;
    for (int t = 0; t < bd.y - bd.x; ++t) {
      const double w = t < rows ? sm.melt[t * nfilters + m]
                                : mel[(bd.x + t) * nfilters + m];
      acc = fma(pw[bd.x + t], w, acc);
    }
    if (mel_floor != 0.0) acc = fmax(acc, mel_floor);
    lm[m] = log2(acc);
  }
  __syncwarp();

  for (int c = l; c < ncep; c += kLanes) {
    double acc = 0.0;
    for (int m = 0; m < nfilters; ++m) acc = fma(lm[m], dct[m * ncep + c], acc);
    out[c] = static_cast<float>(acc);
  }
  __syncwarp();   // the row is free for the warp's next frame
}

}  // namespace fladder_stages
