// K11 and K11-norm for Hopper (sm_90a): Whisper's log-mel front-end
// (config.WhisperConfig; openai/whisper whisper/audio.py log_mel_spectrogram)
// on (B, T) int16 or f32 windows of samples in int16's scale:
//
//   K11       whisper_logmel_kernel  -> L = log10(max(mel power, 1e-10)), f32,
//                                        (B, nfilters, F), and each tile's max
//   K11-norm  whisper_norm_kernel    -> max(L, max_window(L) - 8), (L + 4) / 4,
//                                        in place
//
// It replaces no TPU kernel: the JAX package has no Whisper recipe.  K11
// shares the FP64 tail's mel stage (fladder_stages.cuh mel_log2: the bank's
// nonzero terms on K1's balanced schedule over the warp's 32 lanes, the
// floor and the log), its window products (window_pair), its real-spectrum
// unpack (bin_power) and its persistent grid (persistent.cuh).
//
// Per frame f of window b, one warp (ops/whisper.py log_mel_plain is the
// same function in torch):
//  * the ingest: point m = 0..199 of the packed frame is z[m] = (a(2m) w_2m,
//    a(2m+1) w_2m+1), a(n) the sample f*hop - 200 + n reflected at both ends
//    (n -> -n below 0, n -> 2T - 2 - n from T: only frames 0, 1 and F - 1
//    reach past an end), w the periodic Hann over 32768 (exact: a power of
//    two), each product rounded once; lane l takes m = l + 32r and stores z[m]
//    to the warp's row at its digit-reversed position (below);
//  * the 400-point real DFT as a 200-point complex FFT, 200 = 8 x 5 x 5, in
//    place in the row by decimation in time from the digit-reversed order
//    (ops/whisper.py fft_model, held to torch.fft.fft by the tests): 25
//    radix-8 butterflies (lanes 0-24), then 40 radix-5 ones twice (lanes
//    0-31, then 0-7), the twiddles W_400^k from a table in shared memory;
//    the row then holds Z[k] in natural order;
//  * |X_k|^2 for k < 200 from Z[k], Z[200 - k] and W_400^k (bin 200, which
//    the bank never weighs, is not computed), to the row as doubles;
//  * the mel sums on the schedule (13 steps a lane for large-v3's 394 terms
//    and v1-v2's 391), the floor 1e-10 and log2, lane j taking filters j,
//    j + 32, ... (four rounds at 128); log10 = log2 * log10(2);
//  * L rounded to f32 into a tile of 32 consecutive frames of one window in
//    shared memory, (nfilters, 33) floats: a warp stores its frame's column,
//    and once the tile's frames are done the block writes each filter's row
//    of 32 frames with consecutive threads on consecutive words, where a
//    warp storing its own column would write 128 words F apart.  Each tile's
//    max goes to tile_max (B, ceil(F / 32)): no atomics and no buffer to
//    clear before the launch.
// K11-norm reduces a window's tile maxima once a block and rewrites the
// window's values in place, four floats a thread where the window's
// nfilters * F is a multiple of 4.
//
// The silent path.  Whisper pads each utterance with zeros to 30 s, so
// most of a short clip's frames read nothing but zeros.  For such a frame
// every stage above gives a known value: the window products and the FFT
// are +0 or -0, the power and the mel sums +0, the floor 1e-10, so L is
// log2(fmax(+0, 1e-10)) * log10(2) rounded to f32 for each filter, the same
// bits every time.  K11 stores that value, computed once a block through
// the same fmax, log2, product and rounding as mel_log2 and the store
// (silent_level), and skips the FFT, the unpack, the mel and the log:
//  * per frame: the ingest ORs the raw bits of the 400 samples it loads (an
//    int16's every bit, an f32's all but the sign: -0.0 is zero, NaN and Inf
//    are not); after the window products, one __any_sync sends the warp
//    either on to the FFT or to the store of the value into the tile's
//    column and the tile max.  Deciding before the products cost speech
//    frames 2-3% (their conversions waited for every load); a frame that
//    reaches past neither end reads its samples without the reflection's
//    64-bit compares and selects, which more than pays for the OR and vote;
//  * per tile: the block first reads the first 256 samples of the tile's
//    span [f0*hop - 200, (f0 + nf - 1)*hop + 200), clipped to the window,
//    with one __syncthreads_or; only where all are zero does it read the
//    rest (block_nonzero), and a tile whose span is all zero is written
//    whole with the value, its max the value, without the frame loop.  The
//    span holds every sample its frames reflect to: the right end's lie
//    below T, the left end's at 1 .. 200, so the first tile's span reaches
//    at least to sample 200 (frame 0 reads x[200] for x[-200], and is the
//    tile's only frame where F = 1).
// Silent frames feed the tile max as stored frames do, so each tile max,
// the window's clamp and K11-norm's output are those of the full path bit
// for bit.  The block counts the frames it took on the silent path and adds
// them once, at its end, to the device int64 `silent` (ops/whisper.py
// silent_frames reads it).
//
// Precision: FP64 from the samples to the log, as the FP64 tail's stages it
// shares; L is rounded to f32 once, and the clamp and the affine run in f32
// on it, as the plain version computes them.
//
// What bounds it at the cell's size (B = 128 x T = 480,000: 384,000 frames):
// 123 MB of int16 read and 197 MB of f32 written once, 0.095 ms at 3.35
// TB/s; K11-norm reads and writes the output once more (0.137 ms a call
// back to back against 0.117 for those bytes).  A speech frame takes 3.33 ns
// (1.277 ms a call of speech only; 3.44 before the silent path), bound by
// instruction issue as K1 is: the FFT's shared-memory butterflies (three
// quarters of the lanes idle in the radix-5 stages' second round), the
// unpack, the mel schedule and four rounds of FP64 log2.  A call of zeros
// takes 0.163 ms (against 1.319), so at the cell's padding (45.6% of the
// frames silent) K11 takes 0.819 ms against 1.319 (one process, on the same
// tensors, H100 80GB HBM3, 700 W).  Its row padding (sl) took it from 2.110
// to 1.425 ms, three blocks an SM to 1.306.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fladder_stages.cuh"
#include "persistent.cuh"

namespace {

using fladder_stages::bin_power;
using fladder_stages::cmul;
using fladder_stages::kFrames;
using fladder_stages::kLanes;
using fladder_stages::kThreads;
using fladder_stages::lane;
using fladder_stages::mel_log2;
using fladder_stages::Smem;
using fladder_stages::window_pair;

constexpr int kNfft = 400;
constexpr int kN = kNfft / 2;          // packed complex points
constexpr int kRow = kN + kN / 8;      // double2 a warp's row (slot below)
constexpr int kMaxFilters = 128;       // ops/whisper.py MAX_FILTERS
constexpr int kTile = 32;              // frames a tile (TILE_FRAMES)
constexpr int kTileStride = kTile + 1; // floats a tile row: no bank conflict
constexpr int kMelCap = 16;            // schedule steps a lane (MEL_CAP)
// Blocks an SM at least: 3 caps K11 at 80 registers (no spill) and fits
// 3 x 64 KB of shared memory; at 2 the compiler took 120 and K11 ran 8.4%
// slower (1.4252 against 1.3058 ms at the cell's size, H100 80GB HBM3).
constexpr int kResident = 3;
constexpr double kLogFloor = 1e-10;
constexpr double kLog10of2 = 0.30102999566398119521;
constexpr int kRounds = (kN + kLanes - 1) / kLanes;   // ingest rounds a lane

// Dynamic shared memory of K11's block: the warps' rows, the twiddles, the
// window pairs, the mel schedule and its gather words, the tile and the
// warps' maxima.
constexpr size_t kSmemBytes =
    sizeof(double2) * (kFrames * kRow + kNfft + kN + kMelCap * kLanes) +
    sizeof(unsigned) * kMaxFilters +
    sizeof(float) * (kMaxFilters * kTileStride + kFrames);

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

// -i * a
__device__ __forceinline__ double2 mul_mi(double2 a) {
  return make_double2(a.y, -a.x);
}

// The 4-point DFT of (a0, a1, a2, a3) into (y0, y1, y2, y3).
__device__ __forceinline__ void dft4(double2 a0, double2 a1, double2 a2,
                                     double2 a3, double2& y0, double2& y1,
                                     double2& y2, double2& y3) {
  const double2 s0 = cadd(a0, a2), s1 = cadd(a1, a3);
  const double2 d0 = csub(a0, a2), d1 = mul_mi(csub(a1, a3));
  y0 = cadd(s0, s1);
  y2 = csub(s0, s1);
  y1 = cadd(d0, d1);
  y3 = csub(d0, d1);
}

// The 8-point DFT of v in place, natural order: a radix-2 split into the
// even outputs (the 4-point DFT of v[k] + v[k+4]) and the odd ones (that of
// (v[k] - v[k+4]) W_8^k).
__device__ __forceinline__ void dft8(double2 (&v)[8]) {
  constexpr double h = 0.70710678118654752440;   // sqrt(1/2)
  double2 u[4], d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    u[k] = cadd(v[k], v[k + 4]);
    d[k] = csub(v[k], v[k + 4]);
  }
  d[1] = make_double2(h * (d[1].x + d[1].y), h * (d[1].y - d[1].x));
  d[2] = mul_mi(d[2]);
  d[3] = make_double2(h * (d[3].y - d[3].x), -h * (d[3].x + d[3].y));
  dft4(u[0], u[1], u[2], u[3], v[0], v[2], v[4], v[6]);
  dft4(d[0], d[1], d[2], d[3], v[1], v[3], v[5], v[7]);
}

// The 5-point DFT of v in place: X_0 = v0 + t1 + t2, and with t1 = v1 + v4,
// t2 = v2 + v3, t3 = v1 - v4, t4 = v2 - v3,
//   X_1, X_4 = v0 + c1 t1 + c2 t2 -/+ i (s1 t3 + s2 t4),
//   X_2, X_3 = v0 + c2 t1 + c1 t2 -/+ i (s2 t3 - s1 t4),
// c_k = cos(2 pi k / 5), s_k = sin(2 pi k / 5).
__device__ __forceinline__ void dft5(double2 (&v)[5]) {
  constexpr double c1 = 0.30901699437494742410;
  constexpr double c2 = -0.80901699437494742410;
  constexpr double s1 = 0.95105651629515357212;
  constexpr double s2 = 0.58778525229247312917;
  const double2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
  const double2 t3 = csub(v[1], v[4]), t4 = csub(v[2], v[3]);
  const double2 a1 = make_double2(v[0].x + c1 * t1.x + c2 * t2.x,
                                  v[0].y + c1 * t1.y + c2 * t2.y);
  const double2 a2 = make_double2(v[0].x + c2 * t1.x + c1 * t2.x,
                                  v[0].y + c2 * t1.y + c1 * t2.y);
  const double2 b1 = make_double2(s1 * t3.x + s2 * t4.x,
                                  s1 * t3.y + s2 * t4.y);
  const double2 b2 = make_double2(s2 * t3.x - s1 * t4.x,
                                  s2 * t3.y - s1 * t4.y);
  v[0] = cadd(v[0], cadd(t1, t2));
  v[1] = make_double2(a1.x + b1.y, a1.y - b1.x);
  v[4] = make_double2(a1.x - b1.y, a1.y + b1.x);
  v[2] = make_double2(a2.x + b2.y, a2.y - b2.x);
  v[3] = make_double2(a2.x - b2.y, a2.y + b2.x);
}

// A sample's raw bits for the silent test: an int16's 16, an f32's 32.
__device__ __forceinline__ unsigned raw_bits(int16_t v) {
  return static_cast<unsigned short>(v);
}
__device__ __forceinline__ unsigned raw_bits(float v) {
  return __float_as_uint(v);
}

// Whether the OR of samples' raw bits holds a nonzero sample: any bit of an
// int16; any bit but the sign of an f32 (-0.0 is zero, NaN and Inf not).
template <typename In>
__device__ __forceinline__ bool nonzero_bits(unsigned bits) {
  return std::is_same<In, float>::value ? (bits << 1) != 0u : bits != 0u;
}

// L of a frame whose samples are all zero (see the notes above): mel_log2's
// floor and log2 of a +0 mel sum and the store's product and rounding.  The
// +0 is computed at run time (0 * the window's first value, which is 0), so
// that the compiler does not fold the log2 but runs libdevice's, as the full
// path does.
__device__ __forceinline__ float silent_level(double w0) {
  const double acc = __dmul_rn(0.0, w0);
  return static_cast<float>(log2(fmax(acc, kLogFloor)) * kLog10of2);
}

// Whether any of the samples x[lo, hi) is nonzero: the block reads them once,
// 16 bytes a load on the aligned stretch and one sample a thread at its ends,
// and ORs every thread's bits in one __syncthreads_or (every thread calls).
template <typename In>
__device__ __forceinline__ bool block_nonzero(const In* x, long long lo,
                                              long long hi) {
  const In* p = x + lo;
  const In* q = x + hi;
  const uint4* va = reinterpret_cast<const uint4*>(
      (reinterpret_cast<uintptr_t>(p) + 15) & ~static_cast<uintptr_t>(15));
  const uint4* vb = reinterpret_cast<const uint4*>(
      reinterpret_cast<uintptr_t>(q) & ~static_cast<uintptr_t>(15));
  unsigned bits = 0;
  if (va < vb) {
    const In* pa = reinterpret_cast<const In*>(va);
    const In* qb = reinterpret_cast<const In*>(vb);
    if (threadIdx.x < pa - p) bits = raw_bits(p[threadIdx.x]);
    if (threadIdx.x < q - qb) bits |= raw_bits(qb[threadIdx.x]);
#pragma unroll 4
    for (long long k = threadIdx.x; k < vb - va; k += blockDim.x) {
      const uint4 v = va[k];
      bits |= v.x | v.y | v.z | v.w;
    }
  } else {
    for (long long k = threadIdx.x; k < q - p; k += blockDim.x)
      bits |= raw_bits(p[k]);
  }
  return __syncthreads_or(nonzero_bits<In>(bits));
}

// The row position of packed point m before the FFT: with m = q3 + 5 q2 +
// 25 q1 (q3, q2 < 5, q1 < 8), 40 q3 + 8 q2 + q1.
__device__ __forceinline__ int digit_pos(int m) {
  const int q1 = m / 25, r = m - 25 * q1;
  const int q2 = r / 5;
  return 40 * (r - 5 * q2) + 8 * q2 + q1;
}

// The row slot of FFT position p: a pad double2 after every 8, so that the
// radix-8 stage's lanes (8 positions apart) and the digit-reversed scatter
// (40 apart) fall on distinct 16-byte banks, as the radix-5 stages' and the
// unpack's consecutive positions do (at most 2-way, against 8-way without).
__device__ __forceinline__ int sl(int p) { return p + (p >> 3); }

// Sample n of a window of T samples, reflected at both ends (T > 200).
__device__ __forceinline__ long long reflect(long long n, long long T) {
  n = n < 0 ? -n : n;
  return n >= T ? 2 * T - 2 - n : n;
}

// The 200-point FFT of the warp's row in place, from the digit-reversed
// order to the natural one (see the notes above), position p at slot sl(p).
__device__ __forceinline__ void fft200(double2* row, const double2* tw) {
  const int l = lane();
  if (l < 25) {                       // radix 8: positions 8b + q
    double2 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = row[sl(8 * l + q)];
    dft8(v);
#pragma unroll
    for (int q = 0; q < 8; ++q) row[sl(8 * l + q)] = v[q];
  }
  __syncwarp();
  for (int b = l; b < 40; b += kLanes) {   // radix 5 over sub-DFTs of 8
    const int j = b & 7;
    const int base = 40 * (b >> 3) + j;
    double2 v[5];
    v[0] = row[sl(base)];
#pragma unroll
    for (int q = 1; q < 5; ++q)
      v[q] = cmul(row[sl(base + 8 * q)], tw[10 * j * q]);
    dft5(v);
#pragma unroll
    for (int q = 0; q < 5; ++q) row[sl(base + 8 * q)] = v[q];
  }
  __syncwarp();
  for (int b = l; b < 40; b += kLanes) {   // radix 5 over sub-DFTs of 40
    double2 v[5];
    v[0] = row[sl(b)];
#pragma unroll
    for (int q = 1; q < 5; ++q) v[q] = cmul(row[sl(b + 40 * q)], tw[2 * b * q]);
    dft5(v);
#pragma unroll
    for (int q = 0; q < 5; ++q) row[sl(b + 40 * q)] = v[q];
  }
  __syncwarp();
}

// K11: a persistent walk over tiles of 32 frames of one window, B * ceil(F /
// 32) of them, tile t of window t / tpw.  Warp w of the block takes the
// tile's frames w, w + 8, w + 16, w + 24.  Frames that read only zeros take
// the silent path (see the notes above), counted into *silent.
template <typename In>
__global__ void __launch_bounds__(kThreads, kResident)
whisper_logmel_kernel(const In* __restrict__ in, float* __restrict__ out,
                      float* __restrict__ tile_max, long long T, int F,
                      int hop, int tpw, long long tiles, int nfilters,
                      const double2* __restrict__ win,
                      const double2* __restrict__ tw,
                      const double2* __restrict__ msched, int msteps,
                      unsigned long long* __restrict__ silent) {
  extern __shared__ double2 smem[];
  __shared__ float level;             // L of a silent frame (silent_level)
  __shared__ unsigned block_silent;   // the block's silent frames
  double2* rows = smem;
  double2* tws = rows + kFrames * kRow;
  double2* wins = tws + kNfft;
  Smem sm{};
  sm.msched = wins + kN;
  sm.mgather = reinterpret_cast<unsigned*>(sm.msched + kMelCap * kLanes);
  sm.melt = reinterpret_cast<double*>(sm.msched);
  sm.R = kN;
  sm.msteps = msteps;
  float* tile = reinterpret_cast<float*>(sm.mgather + kMaxFilters);
  float* wmax = tile + kMaxFilters * kTileStride;

  for (int i = threadIdx.x; i < kNfft; i += blockDim.x) tws[i] = tw[i];
  for (int i = threadIdx.x; i < kN; i += blockDim.x) wins[i] = win[i];
  const int n = msteps * kLanes;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sm.msched[i] = msched[i];
  const unsigned* gather = reinterpret_cast<const unsigned*>(msched + n);
  for (int i = threadIdx.x; i < nfilters; i += blockDim.x)
    sm.mgather[i] = gather[i];
  if (threadIdx.x == 0) {
    level = silent_level(win[0].x);
    block_silent = 0;
  }
  __syncthreads();

  const int l = lane();
  const int w = threadIdx.x / kLanes;
  double2* row = rows + w * kRow;
  double* pw = reinterpret_cast<double*>(row);

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long b = t / tpw;
    const int f0 = static_cast<int>(t - b * tpw) * kTile;
    const int nf = min(kTile, F - f0);
    const In* x = in + b * T;
    {
      const long long lo = max(0LL, static_cast<long long>(f0) * hop - kN);
      const long long hi = min(
          T, max(static_cast<long long>(f0 + nf - 1) * hop + kN, kN + 1LL));
      const long long i = lo + threadIdx.x;
      const unsigned bits = i < hi ? raw_bits(x[i]) : 0u;
      if (!__syncthreads_or(nonzero_bits<In>(bits)) &&
          !block_nonzero(x, lo, hi)) {
        const float v = level;
        float* dst = out + b * nfilters * F + f0;
        for (int e = threadIdx.x; e < nfilters * kTile; e += blockDim.x) {
          const int m = e / kTile, c = e - m * kTile;
          if (c < nf) dst[static_cast<long long>(m) * F + c] = v;
        }
        if (threadIdx.x == 0) {
          tile_max[t] = v;
          block_silent += nf;
        }
        continue;
      }
    }
    float mx = -INFINITY;
    for (int c = w; c < nf; c += kFrames) {
      const long long s0 = static_cast<long long>(f0 + c) * hop - kN;
      // the ingest (the window products to the row) and the OR of the raw
      // samples; a frame that reaches past neither end (all but frames 0, 1
      // and F - 1) reads x[s0 + i] without the reflection's arithmetic
      const auto ingest = [&](auto at) {
        unsigned bits = 0;
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          const int m = l + kLanes * r;
          if (m < kN) {
            const In a0 = at(2 * m), a1 = at(2 * m + 1);
            bits |= raw_bits(a0) | raw_bits(a1);
            row[sl(digit_pos(m))] = window_pair(
                static_cast<double>(a0), static_cast<double>(a1), wins[m]);
          }
        }
        return bits;
      };
      const unsigned bits =
          s0 >= 0 && s0 + kNfft <= T
              ? ingest([&](int i) { return x[s0 + i]; })
              : ingest([&](int i) { return x[reflect(s0 + i, T)]; });
      if (!__any_sync(0xffffffffu, nonzero_bits<In>(bits))) {
        const float v = level;
        for (int m = l; m < nfilters; m += kLanes) {
          tile[m * kTileStride + c] = v;
          mx = fmaxf(mx, v);
        }
        if (l == 0) atomicAdd(&block_silent, 1u);
        continue;
      }
      __syncwarp();
      fft200(row, tws);

      double p[kRounds];
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int k = l + kLanes * u;
        if (k < kN)
          p[u] = bin_power(row[sl(k)], row[sl(k ? kN - k : 0)], tws[k]);
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int k = l + kLanes * u;
        if (k < kN) pw[k] = p[u];
      }
      __syncwarp();

      const double* lm = mel_log2<kMelCap>(pw, sm, nfilters, nullptr, nullptr,
                                           kLogFloor);
      for (int m = l; m < nfilters; m += kLanes) {
        const float v = static_cast<float>(lm[m] * kLog10of2);
        tile[m * kTileStride + c] = v;
        mx = fmaxf(mx, v);
      }
      __syncwarp();   // the row is free for the warp's next frame
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (l == 0) wmax[w] = mx;
    __syncthreads();
    float* dst = out + b * nfilters * F + f0;
    for (int e = threadIdx.x; e < nfilters * kTile; e += blockDim.x) {
      const int m = e / kTile, c = e - m * kTile;
      if (c < nf) dst[static_cast<long long>(m) * F + c] = tile[m * kTileStride + c];
    }
    if (threadIdx.x == 0) {
      float v = wmax[0];
#pragma unroll
      for (int i = 1; i < kFrames; ++i) v = fmaxf(v, wmax[i]);
      tile_max[t] = v;
    }
    __syncthreads();   // the tile is free for the next one
  }
  if (threadIdx.x == 0 && block_silent && silent)
    atomicAdd(silent, static_cast<unsigned long long>(block_silent));
}

// K11-norm: block (x, y) takes its share of windows y, y + gridDim.y, ...:
// the window's max from its tpw tile maxima, then each value v -> (max(v,
// max - range) + 4) / 4 in place, float4 at a time where the window's n =
// nfilters * F values are a multiple of 4 (the window then starts 16-byte
// aligned).
__global__ void __launch_bounds__(kThreads)
whisper_norm_kernel(float* __restrict__ out, const float* __restrict__ tile_max,
                    long long B, long long n, int tpw, float range) {
  __shared__ float red[kFrames];
  const int l = lane(), w = threadIdx.x / kLanes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    float v = -INFINITY;
    for (int i = threadIdx.x; i < tpw; i += blockDim.x)
      v = fmaxf(v, tile_max[b * tpw + i]);
#pragma unroll
    for (int o = kLanes / 2; o > 0; o /= 2)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (l == 0) red[w] = v;
    __syncthreads();
    float top = red[0];
#pragma unroll
    for (int i = 1; i < kFrames; ++i) top = fmaxf(top, red[i]);
    const float lo = top - range;
    float* p = out + b * n;
    const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                            threadIdx.x;
    if ((n & 3) == 0) {
      float4* p4 = reinterpret_cast<float4*>(p);
      for (long long i = first; i < n / 4; i += stride) {
        float4 q = p4[i];
        q.x = (fmaxf(q.x, lo) + 4.0f) * 0.25f;
        q.y = (fmaxf(q.y, lo) + 4.0f) * 0.25f;
        q.z = (fmaxf(q.z, lo) + 4.0f) * 0.25f;
        q.w = (fmaxf(q.w, lo) + 4.0f) * 0.25f;
        p4[i] = q;
      }
    } else {
      for (long long i = first; i < n; i += stride)
        p[i] = (fmaxf(p[i], lo) + 4.0f) * 0.25f;
    }
    __syncthreads();   // red is free for the next window
  }
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer; both launch on `stream` on the calling
// thread's current device without synchronizing and return a cudaError_t.
//
// whisper_logmel: `in` holds B windows of T samples (int16 when in_i16,
// else f32), T > 200, F = T / hop frames each; out is (B, nfilters, F) f32
// and tile_max (B, ceil(F / 32)) f32; nfilters <= 128.  win holds the 400
// float64 window values (the periodic Hann over 32768), tw 400 interleaved
// complex float64 twiddles exp(-2 pi i k / 400), msched the mel schedule of
// msteps (1 to 16) steps a lane and its nfilters gather words
// (ops/fladder.py mel_schedule over bins [0, 200)); silent, where not null,
// a device int64 that the launch adds its silent frames to.
extern "C" int whisper_logmel(int in_i16, const void* in, float* out,
                              float* tile_max, long long B, long long T,
                              int F, int hop, int nfilters, const double* win,
                              const double* tw, const void* msched,
                              int msteps, long long* silent, void* stream) {
  if (B < 0 || T <= kN || hop < 1 || F < 1 ||
      static_cast<long long>(F) != T / hop || nfilters < 1 ||
      nfilters > kMaxFilters || !msched || msteps < 1 || msteps > kMelCap)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int tpw = (F + kTile - 1) / kTile;
  const long long tiles = B * tpw;
  const auto walk = [&](auto* x) {
    using In = std::remove_const_t<std::remove_pointer_t<decltype(x)>>;
    return launch_persistent(
        whisper_logmel_kernel<In>, kThreads, tiles, kSmemBytes, stream, x,
        out, tile_max, T, F, hop, tpw, tiles, nfilters,
        reinterpret_cast<const double2*>(win),
        reinterpret_cast<const double2*>(tw),
        static_cast<const double2*>(msched), msteps,
        reinterpret_cast<unsigned long long*>(silent));
  };
  return in_i16 ? walk(static_cast<const int16_t*>(in))
                : walk(static_cast<const float*>(in));
}

// whisper_norm: out (B, nfilters, F) f32 in place from whisper_logmel's
// tile maxima (B, tpw), range the clamp's span below the window's max (8).
extern "C" int whisper_norm(float* out, const float* tile_max, long long B,
                            int nfilters, int F, int tpw, double range,
                            void* stream) {
  if (B < 0 || nfilters < 1 || F < 1 || tpw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const long long n = static_cast<long long>(nfilters) * F;
  const long long per_block = 4LL * kThreads * 4;   // 4 float4 a thread
  const long long chunks = (n + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(chunks < 65535 ? chunks : 65535),
                  static_cast<unsigned>(B < 65535 ? B : 65535));
  whisper_norm_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      out, tile_max, B, n, tpw, static_cast<float>(range));
  return static_cast<int>(cudaGetLastError());
}
