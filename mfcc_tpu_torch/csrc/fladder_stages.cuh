// Device functions of the float MFCC tail, in FP64: the packed radix-4 DIF
// FFT, the real-spectrum unpack and power, the banded mel sum with floor and
// log2, and the DCT product with the (S, F, ncep) f32 store.  Shared by K1
// (fladder.cu, from raw audio) and the float serving step K4
// (stream_step.cu, from carry and chunk): each kernel has its own ingest,
// which writes a tile of FT frames, packed as z[m] = y[2m] + i*y[2m+1]
// after the window * 1/nfft, into the tile's shared rows; the tail is the
// same arithmetic in the same order for both.  K8 (dense_dft.cu) shares
// the stages after the power: mel_log2 and dct_store.
//
// Layout: the block's dynamic shared memory holds FT padded rows of M =
// nfft/2 complex points (one pad double2 per 16, which spreads the
// bit-reversed reads of the unpack over the banks; without it they
// serialize ~8x), the nfft/2 twiddles W^k, the FT x nfft/2 power rows, the
// FT x nfilters log-mel rows and the mel band limits.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace fladder_stages {

constexpr int kThreads = 256;
constexpr int kTilePoints = 1024;   // packed complex points per block
constexpr int kPadShift = 4;        // one pad double2 per 16

__device__ __forceinline__ int pad(int p) { return p + (p >> kPadShift); }

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int bitrev(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

// log2(nfft), or -1 unless nfft is a power of two >= 8.
inline int log2_nfft(int nfft) {
  int l = 0;
  while ((1 << l) < nfft) ++l;
  return (nfft >= 8 && (1 << l) == nfft) ? l : -1;
}

// Frames per block: kTilePoints packed points per tile (4 at nfft 512).
inline int frames_per_block(int nfft) {
  const int M = nfft / 2;
  return M >= kTilePoints ? 1 : kTilePoints / M;
}

// Dynamic shared memory of one block (see Smem).
inline size_t smem_bytes(int FT, int nfft, int nfilters) {
  const size_t M = nfft / 2;
  return sizeof(double2) * (FT * (M + (M >> kPadShift)) + M) +
         sizeof(double) * FT * (M + nfilters) + sizeof(int2) * nfilters;
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

// The block's shared arrays, carved from the dynamic shared memory.
struct Smem {
  double2* buf;     // FT x R packed rows (R = M + M/16)
  double2* stw;     // nbins twiddles W^k
  double* power;    // FT x nbins
  double* logmel;   // FT x nfilters
  int2* sband;      // nfilters [lo, hi)
  int R;
};

__device__ __forceinline__ Smem carve(double2* smem, int FT, int log2n,
                                      int nfilters) {
  const int M = 1 << (log2n - 1);
  Smem sm;
  sm.R = M + (M >> kPadShift);
  sm.buf = smem;
  sm.stw = sm.buf + FT * sm.R;
  sm.power = reinterpret_cast<double*>(sm.stw + M);
  sm.logmel = sm.power + FT * M;
  sm.sband = reinterpret_cast<int2*>(sm.logmel + FT * nfilters);
  return sm;
}

// Copy the twiddles and band limits into shared memory (no barrier: the
// ingest's closing barrier covers it).
__device__ __forceinline__ void load_constants(const Smem& sm, const double2* tw,
                                               const int2* band, int nbins,
                                               int nfilters) {
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) sm.stw[i] = tw[i];
  for (int i = threadIdx.x; i < nfilters; i += blockDim.x) sm.sband[i] = band[i];
}

// The mel product of FT power rows (row f at power + f * nbins) over each
// filter's band [lo, hi) of `band` ((nbins, nfilters) row-major mel), the
// optional floor and log2, into logmel[f * nfilters + m].  Shared by K1's
// tail and K8 (dense_dft.cu).
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
// out[(f0 + f) * ncep + c], rounded to f32 once.  Shared by K1's tail and
// K8 (dense_dft.cu).
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

// Everything after the ingest, which has filled sm.buf and ended with a
// barrier: the FFT, |X|^2, mel, floor, log2 and the DCT product, storing
// cepstra of frames f0 + f < F at out[(f0 + f) * ncep + c] (out points at
// the stream's (F, ncep) rows).
__device__ __forceinline__ void ladder_tail(const Smem& sm, int FT, int log2n,
                                            int nfilters, int ncep,
                                            const double* __restrict__ mel,
                                            const double* __restrict__ dct,
                                            double mel_floor,
                                            float* __restrict__ out, int f0,
                                            int F) {
  const int nbins = 1 << (log2n - 1);
  const int log2m = log2n - 1;          // packed FFT size M = nfft/2
  const int M = nbins;
  const int R = sm.R;
  double2* buf = sm.buf;
  const double2* stw = sm.stw;

  // 1. M-point DIF FFT.  A radix-4 pass merges the radix-2 stages of spans
  //    2h and h (group 4h, twiddle w = W_4h^j): outputs b0+b2, (b0-b2) w^2,
  //    (b1+b3) w, (b1-b3) w^3 with b0,b1 = a0 +- a2, b2 = a1 + a3,
  //    b3 = -i (a1 - a3).  W_4h^j = W_nfft^(j << (st + 1)).
  for (int st = 0; st < log2m;) {
    if (log2m - st >= 2) {
      const int l2h = log2m - st - 2;
      const int h = 1 << l2h;
      for (int b = threadIdx.x; b < FT * (M >> 2); b += blockDim.x) {
        const int q = b & ((M >> 2) - 1);
        const int j = q & (h - 1);
        const int i0 = ((q >> l2h) << (l2h + 2)) + j;
        double2* row = buf + (b >> (log2m - 2)) * R;
        const int p0 = pad(i0), p1 = pad(i0 + h), p2 = pad(i0 + 2 * h), p3 = pad(i0 + 3 * h);
        const double2 a0 = row[p0], a1 = row[p1], a2 = row[p2], a3 = row[p3];
        const double2 w = stw[j << (st + 1)];
        const double2 w2 = stw[j << (st + 2)];
        const double2 w3 = cmul(w, w2);
        const double2 b0 = make_double2(a0.x + a2.x, a0.y + a2.y);
        const double2 b1 = make_double2(a0.x - a2.x, a0.y - a2.y);
        const double2 b2 = make_double2(a1.x + a3.x, a1.y + a3.y);
        const double2 b3 = make_double2(a1.y - a3.y, a3.x - a1.x);
        row[p0] = make_double2(b0.x + b2.x, b0.y + b2.y);
        row[p1] = cmul(make_double2(b0.x - b2.x, b0.y - b2.y), w2);
        row[p2] = cmul(make_double2(b1.x + b3.x, b1.y + b3.y), w);
        row[p3] = cmul(make_double2(b1.x - b3.x, b1.y - b3.y), w3);
      }
      st += 2;
    } else {  // last radix-2 stage: span 1, twiddle 1
      for (int b = threadIdx.x; b < FT * (M >> 1); b += blockDim.x) {
        double2* row = buf + (b >> (log2m - 1)) * R;
        const int i0 = 2 * (b & ((M >> 1) - 1));
        const int p0 = pad(i0), p1 = pad(i0 + 1);
        const double2 a = row[p0], c = row[p1];
        row[p0] = make_double2(a.x + c.x, a.y + c.y);
        row[p1] = make_double2(a.x - c.x, a.y - c.y);
      }
      st += 1;
    }
    __syncthreads();
  }

  // 2. unpack the real spectrum (Z[k] sits at bitrev(k)) and take |X|^2.
  for (int b = threadIdx.x; b < FT * nbins; b += blockDim.x) {
    const int f = b >> log2m;
    const int k = b & (nbins - 1);
    const double2* row = buf + f * R;
    const double2 zk = row[pad(bitrev(k, log2m))];
    const double2 zn = row[pad(bitrev((M - k) & (M - 1), log2m))];
    const double2 xe = make_double2(0.5 * (zk.x + zn.x), 0.5 * (zk.y - zn.y));
    const double2 xo = make_double2(0.5 * (zk.y + zn.y), -0.5 * (zk.x - zn.x));
    const double2 wx = cmul(xo, stw[k]);
    const double re = xe.x + wx.x, im = xe.y + wx.y;
    sm.power[f * nbins + k] = re * re + im * im;
  }
  __syncthreads();

  // 3. mel product over each filter's band [lo, hi), floor, log2.
  mel_log2(sm.power, FT, nbins, nfilters, sm.sband, mel, mel_floor, sm.logmel);
  __syncthreads();

  // 4. DCT product and the store.
  dct_store(sm.logmel, FT, nfilters, ncep, dct, out, f0, F);
}

}  // namespace fladder_stages
