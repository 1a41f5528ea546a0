// The FP64 tensor-core product engine of the dense-DFT kernels, for Hopper
// (sm_90a): a tile of signal rows x (K, N) operator, the operator streamed
// by TMA into an mbarrier ring.  Shared by K8 (dense_dft.cu: frames x the
// windowed real-DFT operator, every entry of ops/dense_fused.py) and the
// split-DFT tail of radix2_stages.cuh (K5, K5-frames and K4-split: half
// frames x the nh x nh cos / -sin operator).  It replaces the product at
// the heart of mfcc_tpu/ops/pallas_mfcc.py:_mfcc_kernel (and the five
// other dense-DFT kernels there) and _radix2_core; each kernel keeps its
// own ingest and tail.
//
// Roles.  A block is 8 warps (256 threads), every one a consumer; lane 0
// of each also issues.  The operator streams, chunk after chunk, into a
// ring of `stages` shared buffers: chunk c is fill c / stages of stage c %
// stages.  When a warp releases a chunk it arrives on the stage's `empty`
// mbarrier, and its lane 0 tests (test_wait, which never blocks) whether
// that completed the release of the stage; if so it claims the stage's
// next fill (one CAS on the stage's fill count: two warps may both see
// the release complete, and the fill is issued once), arms the stage's
// `full` mbarrier with the chunk's bytes (arrive.expect_tx) and issues one
// 1-D cp.async.bulk for it, which completes the transaction on `full`.
// So a stage is refilled the moment its last reader lets it go, by that
// reader.  Two designs lost to this one (PERF.md): a producer warp of its
// own (nine warps put three on one SM sub-partition, whose 16,384
// registers then cap a thread at 168, and the kernels spilled 244-304
// bytes), and producers that polled a shared issue counter after every
// release (a loop, a division and a CAS in lane 0 while its warp waited:
// 1.15-1.37x this design's time).  A 1-D bulk copy of a contiguous chunk
// needs no tensor map (so no cuTensorMapEncodeTiled and no -lcuda): the
// host lays the operator out in fragment order, so a chunk is a
// contiguous run of bytes and each lane's A fragment an aligned vector in
// it (a warp's fragment read is conflict-free, no pad).  No __syncthreads
// inside the K loop.  The grid is persistent (one block an SM, each
// taking tiles blockIdx.x, + gridDim.x, ...) and the same operator streams
// for every tile, so the ring holds the next tile's first chunks while a
// tile's tail and the next ingest run.  A wait that outlasts ~2^34 clocks
// traps, so a ring fault shows as a launch failure, not a hung card.
//
// No clusters.  Thread-block clusters with each chunk multicast to every
// CTA of the cluster (one L2 read for all) were built and measured: +3% at
// 2 CTAs with polling producers, and 2.6x slower with the claim above,
// whose refill waits for a local warp when the last release is a peer's.
// The L2 reads of the operator were never the limit (PERF.md, ROADMAP).
//
// The product.  D[col][sig] += A[col][k] * B[k][sig] on the FP64 tensor
// cores, mma.sync m16n8k4 .f64: Hopper's wgmma has no FP64 form, so the
// FP64 product stays on mma.sync.  Of the shapes sm_90 adds, m16n8k8 ran
// 1-4% slower on K8 and K5, m16n8k16 1-2% faster on K8 and 9-10% slower on
// K5 (PERF.md); fed from registers all three reach 65-66 TFLOP/s
// (tools/dmma_rate.cu).  A is the operator (16 output columns x 4 k), B
// the signal rows, FP64 in shared memory (row stride = 4 mod 16 doubles,
// so a B fragment's 8 rows x 4 k meet each bank twice, the least for 256
// bytes).  Warp w owns column tiles [w CT, (w + 1) CT) of 16 against all
// NT tiles of 8 signals: CT NT 4 FP64 accumulators a thread, 64 at every
// nfft (128 registers).  Lane (g, t) = (l / 4, l % 4) holds fragment value
// h of A at column 16 ct + g + 8h, depth t, B of signal 8n + g at depth t,
// and D[j][n][c] at column 16 ct_j + g + 8 (c >> 1), signal 8n + 2t + (c &
// 1).  kKStep and OpT fix the operator's layout, which ops/dmma_product.py
// builds (KSTEP, OP_DTYPE; a CPU test reads them here).
// The operator is held as OpT = f32 (every value the dense kernels
// multiply is an f32 value, limb sums included, so it converts exactly)
// and converted at the fragment: an FP64 operator halves the ring's rows
// and measured 9-12% slower.  Each (column, signal) sums its k in the
// same order in every kernel and tile position, so two tiles of one frame
// give the same bits.
//
// The lo*lo correction of K5 at 3 passes runs on the bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulate) over the bf16 lo limbs of both
// operands: every product is exact in f32; the f32 sum of the nh terms is
// within nh 2^-24 of their absolute sum, itself <= 2^-16 of sum |x c|; the
// result is subtracted once, by starting the FP64 accumulators at it.
//
// What bounds it on the H100: the FP64 MMAs at 67 TFLOP/s (K8 3.0 ms, K5
// 1.5 ms at the headline); the bf16 correction at 989 TFLOP/s is ~3% of
// K5's.  Measured at the headline, the product takes 61-72% of a block's
// cycles at 70-74% of the MMA rate; each tile's ingest (17-25%) and tail
// (10-14%) leave the tensor cores idle, with one block per SM to hide
// nothing; the ring's synchronisation costs 7-17% (PERF.md).  Each CTA
// prefetches its next tile's input into L2 before its product
// (prefetch_l2).  Budget: 256 threads, one block per SM
// (__launch_bounds__(256, 1), 200-254 registers a thread, no spills), 2-4
// ring stages of 16-32 KB beside each kernel's own rows (see there).
//
// Host helpers at the end: the operator's checks, the ring's stages and the
// persistent launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "persistent.cuh"

namespace dmma_product {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;   // 256
constexpr int kThreads = kConsumers;
constexpr int kKStep = 4;          // FP64 MMA depth: m16n8k4
using OpT = float;                 // the streamed FP64-product operator
constexpr int kMaxStages = 4;
constexpr size_t kMaxSmem = 232448;   // a block's limit on sm_90

// -- PTX --------------------------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's threads (all of them consumers).
__device__ __forceinline__ void consumer_sync() { __syncthreads(); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   saddr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// bytes from global src to shared dst, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(saddr(dst)), "l"(src), "r"(bytes),
      "r"(saddr(bar)) : "memory");
}

// d += a * b, FP64, m16n8k4: lane (g, t) holds a[h] = A[column g + 8h][k
// t], b = B[k t][signal g].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2],
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// d += a * b, bf16 in, f32 accumulate, m16n8k16: lane (g, t) holds a as
// (column g, k 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)
// and b as (k 2t..2t+1, signal g), (2t + 8.., g).
__device__ __forceinline__ void bmma(float (&d)[4], const uint4& a,
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// -- the ring ---------------------------------------------------------------

struct Ring {
  unsigned char* data;   // stages x stage_bytes
  uint64_t* full;        // stages
  uint64_t* empty;       // stages
  int* fills;            // stages: the fills of each stage issued so far
  int stages;
  uint32_t stage_bytes;
};

// Shared bytes of the ring's barriers and fill counts (a multiple of 16).
__host__ __device__ inline size_t barrier_bytes() {
  return sizeof(uint64_t) * 2 * kMaxStages + sizeof(int) * kMaxStages;
}

// The ring whose barriers and counts start at `bars` (barrier_bytes).
__device__ __forceinline__ Ring make_ring(unsigned char* data, uint64_t* bars,
                                          int stages, uint32_t stage_bytes) {
  return Ring{data, bars, bars + kMaxStages,
              reinterpret_cast<int*>(bars + 2 * kMaxStages), stages,
              stage_bytes};
}

// Thread 0: the barriers' initial state (full: the issuer's one arrive
// plus the chunk's transaction; empty: every warp of the block), fenced
// for the bulk copies.  The caller's consumer_sync() publishes it before
// any warp issues or arrives.
__device__ __forceinline__ void ring_init(const Ring& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], kConsumerWarps);
      r.fills[s] = 0;
    }
    mbar_init_fence();
  }
}

__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(saddr(bar)), "r"(parity) : "memory");
  return ok != 0;
}

// What the launch streams: chunk c (c < total) is operator chunk c %
// nchunks of the stage_bytes-sized chunks at src, into stage c % stages
// as that stage's fill c / stages.
struct Producer {
  const unsigned char* src;
  int nchunks, total;
};

__device__ __forceinline__ Producer producer(const void* src, int nchunks,
                                             int total) {
  return Producer{static_cast<const unsigned char*>(src), nchunks, total};
}

// A warp's position in the stream: chunk c, its stage s and fill k, its
// operator chunk oc.
struct Cursor {
  int c = 0, s = 0, k = 0, oc = 0;
};

// Lane 0: issue chunk c (stage s, fill k, operator chunk oc) if fill k - 1
// of the stage has been released by every warp and no lane has issued
// fill k yet (claimed with one CAS).  Never waits.
__device__ __forceinline__ void try_issue(const Ring& r, const Producer& p,
                                          int c, int s, int k, int oc) {
  if (c >= p.total) return;
  if (k > 0 && !mbar_test(&r.empty[s], (k - 1) & 1)) return;
  if (atomicCAS(&r.fills[s], k, k + 1) != k) return;
  mbar_expect_tx(&r.full[s], r.stage_bytes);
  bulk_load(r.data + static_cast<size_t>(s) * r.stage_bytes,
            p.src + static_cast<size_t>(oc) * r.stage_bytes, r.stage_bytes,
            &r.full[s]);
}

// The first fill of every stage (thread 0, after the block barrier that
// follows ring_init).
__device__ __forceinline__ void prime(const Ring& r, const Producer& p) {
  if (threadIdx.x == 0)
    for (int s = 0; s < r.stages; ++s) try_issue(r, p, s, s, 0, s % p.nchunks);
}

// Wait for the cursor's chunk (its issue is the job of the warp whose
// release of the stage's previous fill came last, or of prime()).
__device__ __forceinline__ const unsigned char* acquire(const Ring& r,
                                                        const Cursor& cu) {
  const uint32_t a = saddr(&r.full[cu.s]);
  const uint32_t ph = cu.k & 1;
  if (!mbar_try(a, ph)) {
    const long long t0 = clock64();
    while (!mbar_try(a, ph))
      if (clock64() - t0 > (1LL << 34)) __trap();
  }
  return r.data + static_cast<size_t>(cu.s) * r.stage_bytes;
}

// The warp is done with the cursor's chunk: one arrive on its stage's
// empty barrier; lane 0 then refills the stage with chunk c + stages if
// its arrive was the last one.
__device__ __forceinline__ void release(const Ring& r, Cursor& cu,
                                        const Producer& p) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     saddr(&r.empty[cu.s])) : "memory");
    int oc = cu.oc + r.stages;
    while (oc >= p.nchunks) oc -= p.nchunks;
    try_issue(r, p, cu.c + r.stages, cu.s, cu.k + 1, oc);
  }
  ++cu.c;
  if (++cu.oc == p.nchunks) cu.oc = 0;
  if (++cu.s == r.stages) { cu.s = 0; ++cu.k; }
}

// Prefetch lines part, part + parts, ... of the 128-byte lines that hold
// bytes [p, p + n) into L2 (a hint: nothing waits for it).  The kernels
// issue it for their next tile's input before a tile's product, so the
// next ingest reads from L2, not HBM: with one block per SM nothing else
// hides an ingest's memory latency.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t n, int part,
                                            int parts) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (uintptr_t l = (a & ~uintptr_t(127)) + 128 * static_cast<uintptr_t>(part);
       l < a + n; l += 128 * static_cast<uintptr_t>(parts))
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(l));
}

// -- the products -------------------------------------------------------------

template <int CT, int NT>
__device__ __forceinline__ void zero(double (&acc)[CT][NT][4]) {
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][n][c] = 0.0;
}

// Lane's A fragment (two f32 values) as FP64.
__device__ __forceinline__ void load_a(double (&a)[2], const OpT* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a[0] = v.x; a[1] = v.y;
}

// acc += the product of `nchunks` chunks from the ring (rows_per_chunk
// operator rows each, ncol_tiles = kConsumerWarps CT column tiles in all)
// with the FP64 signal rows x (row stride xs; rows past the operator's K
// hold zeros up to nchunks rows_per_chunk).
template <int CT, int NT>
__device__ __forceinline__ void fp64_chunks(double (&acc)[CT][NT][4],
                                            const double* x, int xs,
                                            const Ring& r, Cursor& cu,
                                            const Producer& p, int nchunks,
                                            int rows_per_chunk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ncol_tiles = kConsumerWarps * CT;
  const int steps = rows_per_chunk / kKStep;
  const double* xb = x + g * xs + t;
  int k0 = 0;
  for (int c = 0; c < nchunks; ++c) {
    const OpT* st = reinterpret_cast<const OpT*>(acquire(r, cu)) +
                    (warp * CT * 32 + lane) * 2;
#pragma unroll 2
    for (int ks = 0; ks < steps; ++ks, k0 += kKStep) {
      const OpT* ap = st + ks * ncol_tiles * 32 * 2;
      double b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) b[n] = xb[n * 8 * xs + k0];
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        double a[2];
        load_a(a, ap + j * 32 * 2);
#pragma unroll
        for (int n = 0; n < NT; ++n) dmma(acc[j][n], a, b[n]);
      }
    }
    release(r, cu, p);
  }
}

// corr = the bf16 product of `nchunks` chunks (rows_per_chunk rows of
// bf16 limbs each, fragment order) with the bf16 rows xl (row stride xls
// elements), summed in f32.
template <int CT, int NT>
__device__ __forceinline__ void bf16_chunks(float (&corr)[CT][NT][4],
                                            const __nv_bfloat16* xl, int xls,
                                            const Ring& r, Cursor& cu,
                                            const Producer& p, int nchunks,
                                            int rows_per_chunk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ncol_tiles = kConsumerWarps * CT;
  const int steps = rows_per_chunk / 16;
  const __nv_bfloat16* xb = xl + g * xls + 2 * t;
  int k0 = 0;
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) corr[j][n][c] = 0.0f;
  for (int c = 0; c < nchunks; ++c) {
    const uint4* st = reinterpret_cast<const uint4*>(acquire(r, cu)) +
                      warp * CT * 32 + lane;
    for (int ks = 0; ks < steps; ++ks, k0 += 16) {
      const uint4* ap = st + ks * ncol_tiles * 32;
      uint32_t b[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* p = xb + n * 8 * xls + k0;
        b[n][0] = *reinterpret_cast<const uint32_t*>(p);
        b[n][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const uint4 a = ap[j * 32];
#pragma unroll
        for (int n = 0; n < NT; ++n) bmma(corr[j][n], a, b[n][0], b[n][1]);
      }
    }
    release(r, cu, p);
  }
}

// -- host ---------------------------------------------------------------------

// The streamed operator of one launch, as the wrapper hands it in: `rows`
// rows (K padded with zero rows to whole chunks) of N columns in the
// fragment order of kKStep and OpT (ops/dmma_product.py), chunk_rows rows
// a chunk.
struct Operator {
  const void* data;
  int rows, chunk_rows;
};

// The chunk bytes of o's FP64-product part over N columns, or 0 where o
// does not fit K rows of N columns or the engine.
inline uint32_t chunk_bytes(const Operator& o, int K, int N) {
  if (!o.data || o.chunk_rows < kKStep || o.chunk_rows % kKStep ||
      o.rows < K || o.rows % o.chunk_rows || o.rows - K >= o.chunk_rows)
    return 0;
  const size_t b = sizeof(OpT) * static_cast<size_t>(o.chunk_rows) * N;
  return b % 16 ? 0 : static_cast<uint32_t>(b);
}

// Ring stages for a block whose other shared bytes are `rest`: as many as
// fit, at most kMaxStages; 0 when fewer than 2 fit.
inline int ring_stages(size_t rest, size_t stage_bytes) {
  if (rest + barrier_bytes() >= kMaxSmem) return 0;
  size_t n = (kMaxSmem - rest - barrier_bytes()) / stage_bytes;
  if (n > static_cast<size_t>(kMaxStages)) n = kMaxStages;
  return n >= 2 ? static_cast<int>(n) : 0;
}

// The tiles this block takes in a launch of `launch_persistent`: tile
// blockIdx.x + i gridDim.x for i < turns(ntiles).
__device__ __forceinline__ int turns(long long ntiles) {
  const long long b = blockIdx.x, n = gridDim.x;
  return b < ntiles ? static_cast<int>((ntiles - b + n - 1) / n) : 0;
}

}  // namespace dmma_product
