// The serving step K4 for Hopper (sm_90a): one chunk of every stream in,
// its frames' cepstra, the new carry and (the step-level entries) the new
// stream state out, in one kernel.  Three kernels, float, split-DFT float
// and bit-exact INT:
//
//  mfcc_stream_f32_{i16,f32}:  carry (S, P) f32, chunk (S, C) int16 or f32
//      -> (S, F, ncep) f32 + new carry (S, P) f32, and with the state
//      operands mask (S, F) bool, new count (S,) int32 and new prev (S,)
//      f32.  Replaces the TPU kernel
//      mfcc_tpu/ops/pallas_stream.py:_stream_fladder_kernel (entry
//      stream_step_float) and the state update that mfcc_tpu/streaming.py
//      runs around it in the same jitted step; the tail is K1's
//      (fladder_stages.cuh).
//  mfcc_stream_r2_{i16,f32}:  the carry and chunk operands and new carry of
//      the JAX-signature float step, with K5's split-DFT tail
//      (radix2_stages.cuh) at dft_passes 3, 4 or 6.  Replaces
//      pallas_stream.py:_stream_float_kernel (stream_step_float where
//      use_ladder is false: the precision="fast" serving step).  Its
//      ingest and new carry are K4-float's, so the carry is the same
//      tensor, and a streamed int16 frame reaches the tail with the f32
//      values K5's batch ingest gives it: the same operations.
//  mfcc_stream_int_{i16,i32}:  carry (S, P) int32, chunk (S, C) int16 or
//      int32 -> (S, F, ncep) int32 + new carry (S, P) int32, and the state
//      outputs as for the float step (new prev int32).  Replaces
//      pallas_stream.py:_stream_int_kernel (entry stream_step_int) and its
//      state update; the tail is K3's (int_stages.cuh tail_balanced),
//      element-exact.
//
// The function, per stream s (P = nfft - 1 = windowlen - 1, F = (C - 1) /
// hop + 1): count = reset[s] ? 0 : count[s], prev = reset[s] ? 0 : prev[s]
// (a null reset is no reset; the JAX-signature wrappers pass count = P -
// start and no reset, and drop the state outputs).  Then
//   E[q] = carry[s, q]                                   for q < P,
//          emph(chunk[s, q-P], q == P ? prev : chunk[s, q-P-1])
//                                                        for P <= q < P+C,
//          0                                              beyond (the zero
//          pad of streaming._chunk_step_batch);
//   frame f, point j = E[P - count + f*hop + j] for f < F, then the batch
//   tail; the new carry is E[C : C+P].
// The state outputs: total = count + C, n_valid = max(floor((total -
// windowlen) / hop) + 1, 0) -- an explicit floor: C++'s / truncates toward
// zero and would give one frame for total - windowlen in (-hop, 0) --,
// mask[s, f] = f < n_valid, new count = total - n_valid * hop, new prev =
// the chunk's last raw sample in the state's dtype.  Frame slots past a
// stream's valid count are computed from the zero-padded signal like the
// others (the mask drops them), so kernel and plain version agree on every
// slot.
//
// Emphasis.  Float: x - 0.96875f * p in f32, rounded twice (__fmul_rn /
// __fsub_rn: nvcc would contract it into an FMA, which changes the carry of
// f32 input that is not integer-valued), then the value goes to FP64 for
// the tail.  For int16-valued input the f32 value is exact, so a streamed
// frame is K1's frame, operation for operation.  INT: wrap16(x + (p >> 5)
// - p) mod 2^32 on int32 (preemph32): int32 chunks are taken as they are,
// not mod 2^16 (the TPU step casts them to int32).
//
// Design: a persistent grid (persistent.cuh) over the flat list of M = S*F
// frame slots, as K1 and K3: a block of 8 warps loads its tables once
// (float: K1's twiddles and mel schedule; INT: K3's ladder twiddles, window
// curve and balanced filterbank schedule), then walks tiles of 8 slots G =
// s*F + g, one a warp, in a grid-stride loop (32-bit slot indices: a launch
// refuses S*F >= 2^30), so a tile spans stream boundaries and no warp idles
// where F is not a multiple of 8 (F = 7 at C = 1024: a tile spans 2
// streams).  The float kernel runs at K1's residency (3 blocks an SM at
// nfft 512), the INT kernel at K3's (3, its window curve read from shared
// memory through a volatile pointer).
//
// The staged window (stream_f32_kernel, stream_int_kernel: the main path).
// A block copies the rows of its next tile's streams -- each stream's
// carry row, chunk row and state (count, prev, the word holding its reset
// flag) -- into one of its two row buffers with cp.async while the
// current tile's tails run (rows_issue), so no global load and no address
// arithmetic stands in front of a frame.  One barrier a tile: the tile's
// rows are in (each thread waits for its own copies) and the tile before's
// buffer is read.  Then the block issues the next tile's copies; the
// thread of a stream whose slot 0 is in the tile writes its new count and
// prev, and the block its new carry E[C : C+P) (position p by thread p mod
// 256); each warp writes its mask entry and reads its frame from the rows,
// emphasizing as it reads: a frame wholly inside the chunk at a lane base
// and constant offsets, the others through predicated reads of the carry
// row or the chunk row (e_at), each read a shared-memory load.  A buffer
// holds the tile's streams at a fixed stride, rows_stride(P, C, in_bytes)
// bytes: 4,128 at the serving shape (C = 1024 int16), whose tiles span two
// streams (F = 7), so 8,256 of a buffer's bytes.  The buffers are what
// keeps 3 blocks an SM: 2 x 11,776 bytes beside the float block's 53,232 of
// K1's arrays, 2 x 21,952 beside the INT block's 32,880, 76,784 a block.
// The per-point kernels (stream_*_pointwise_kernel) take every other step:
// a carry or chunk without unit position strides (the (P, S) carry, the
// (C, S) chunk: read in place through their strides, uncoalesced for the
// (C, S) chunk) or a tile's rows over a buffer (at hop 170: the float
// step's f32 chunks and its int16 chunks outside 341-436, 511-924 and
// 1,021-1,908 samples; the INT step's int32 chunks of 167-170 and over
// 2,226 samples).  There each warp reads its stream's
// state, writes carry positions [g * share, (g + 1) * share) of its stream
// (share = ceil(P / F)), mask[s, g] and on slot 0 the new count and prev,
// and reads each point from global memory through branches on its region,
// carry, chunk or pad (the float kernel reads a frame wholly inside the
// chunk at constant offsets instead; with unit position strides the frame
// is read with those strides as constants).  The new carry is a separate
// output (other warps still read the old one).  Offsets are 64-bit: S*C
// passes 2^31 at S=4096 x C=2^19.
//
// What bounds it at the serving shape (S=4096 x C=1024 int16, hop 170: 7
// frame slots, ~6 valid per stream): ~8.4 MB of chunk, ~16.7 MB of carry in
// and out, ~3.7 MB of features, ~9 us of HBM time; the tails' operations
// (chip_smoke.py counts them per valid frame) bound it: ~14 us of FP64 for
// the float step, ~41 us of int32 issue for the INT step.  With the window
// a slot's own work is close to its tail's; what is left above the batch
// kernels' rate a frame is the emphasis on read, the barrier a tile, and
// the grid's last rounds, where an SM's first blocks have finished and its
// last runs alone (3,584 tiles over 396 blocks at the serving shape: 9 or
// 10 a block).  The split-DFT step's limb products bound it at the bf16
// tensor-core rate, and its FP64 product loop bounds this design (see
// radix2_stages.cuh).
//
// Not carried from the TPU kernels: the barrel-shifter alignment
// (_barrel_sublane), the even/odd and sigma frame rebuilds, the (X, bs)
// 128-lane stream blocks and their narrow-lane fallback.  The row buffers
// take the place of the [carry | chunk] scratch concat (pallas_stream.py's
// VMEM scratch), filled a tile ahead and emphasized as they are read.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "fladder_stages.cuh"
#include "int_stages.cuh"
#include "persistent.cuh"
#include "radix2_stages.cuh"

namespace {

// Element strides of the per-stream operands.
struct Strides {
  long long carry_s, carry_p;     // old carry: stream, position
  long long chunk_s, chunk_t;     // chunk: stream, time
  long long ncarry_s, ncarry_p;   // new carry: stream, position
};

// The per-stream state operands of a step, T the state's dtype (f32 or
// int32); every array is (S,) and contiguous but mask, (S, F).  Only reset
// may be null.
template <typename T>
struct StepState {
  const int* count;               // buffered samples
  const unsigned char* reset;     // bool flags, or null: no reset
  const T* prev;                  // the raw sample before the chunk
  unsigned char* mask;            // (S, F) bool: frame slot is a frame
  int* ncount;                    // new count
  T* nprev;                       // new prev: the chunk's last sample
};

template <typename T>
bool state_ok(const StepState<T>& io) {
  return io.count != nullptr && io.prev != nullptr && io.mask != nullptr &&
         io.ncount != nullptr && io.nprev != nullptr;
}

// Checks shared by both steps.
bool shape_ok(long long S, int P, int C, int F, int hop, int nfft) {
  return S >= 0 && C >= 1 && hop >= 1 && P == nfft - 1 &&
         F == (C - 1) / hop + 1 && C <= 0x7fffffff - 2 * nfft;
}

constexpr float kEmphF = 0.96875f;   // 1 - 1/32
constexpr int kU = 8;                // split-DFT ingest pairs in flight a thread

// The float step's points a lane, 2^kLog2P: the serving family's nfft 512
// (stream_fused.stream_config_ok).  Blocks an SM must hold at once, which
// caps the registers at 80: K1's at nfft 512 (fladder.cu kResident) for the
// float step, K3's (int_mfcc.cu) for the INT step.
constexpr int kLog2P = 3;
constexpr int kFloatResident = 3;
constexpr int kIntResident = 3;

__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// floor(a / b) for b > 0 (C++'s / truncates toward zero).
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return q - (q * b > a ? 1 : 0);
}

// E[q] of the float step for one stream (cs, xs: its carry and chunk).
template <typename In>
__device__ __forceinline__ float emph_f32(const float* cs, const In* xs,
                                          float pv, long long q, int P, int C,
                                          const Strides& st) {
  if (q < 0) return 0.0f;
  if (q < P) return cs[q * st.carry_p];
  const long long t = q - P;
  if (t >= C) return 0.0f;
  const float x = to_f32(xs[t * st.chunk_t]);
  const float p = t == 0 ? pv : to_f32(xs[(t - 1) * st.chunk_t]);
  return __fsub_rn(x, __fmul_rn(kEmphF, p));
}

// E[q] of the INT step.
template <typename In>
__device__ __forceinline__ int emph_int(const int* cs, const In* xs, int pv,
                                        long long q, int P, int C,
                                        const Strides& st) {
  if (q < 0) return 0;
  if (q < P) return cs[q * st.carry_p];
  const long long t = q - P;
  if (t >= C) return 0;
  const int x = static_cast<int>(xs[t * st.chunk_t]);
  const int p = t == 0 ? pv : static_cast<int>(xs[(t - 1) * st.chunk_t]);
  return int_stages::preemph32(x, p);
}

// The float frame starting at E[q0]: packed points z[r] = (E[q0 + 2m],
// E[q0 + 2m + 1]) * window / nfft, m = lane + 32r.  A frame wholly inside
// the chunk (chunk indices q0 - P - 1 .. q0 - P + nfft - 1 all valid: 3 of
// the 7 slots a stream at C = 1024) reads three samples a pair at constant
// offsets from the lane's base, the others each point through emph_f32's
// branches.  (The same path saves the INT step too little to keep it:
// PERF.md.)
template <int LOG2P, typename In>
__device__ __forceinline__ void ingest_f32(double2 (&z)[1 << LOG2P],
                                           const float* cs, const In* xs,
                                           float pv, int q0, int P, int C,
                                           const Strides& st,
                                           const double2* win, int l) {
  const int t0 = q0 - P;
  if (t0 >= 1 && t0 + 64 * (1 << LOG2P) <= C) {
    const long long c = st.chunk_t;
    const In* x = xs + (t0 + 2 * l) * c;
#pragma unroll
    for (int r = 0; r < (1 << LOG2P); ++r) {
      const In* y = x + 64 * r * c;
      const float p = to_f32(y[-c]), a = to_f32(y[0]), b = to_f32(y[c]);
      z[r] = fladder_stages::window_pair(
          static_cast<double>(__fsub_rn(a, __fmul_rn(kEmphF, p))),
          static_cast<double>(__fsub_rn(b, __fmul_rn(kEmphF, a))),
          win[l + 32 * r]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < (1 << LOG2P); ++r) {
    const int m = l + 32 * r;
    z[r] = fladder_stages::window_pair(
        static_cast<double>(emph_f32(cs, xs, pv, q0 + 2 * m, P, C, st)),
        static_cast<double>(emph_f32(cs, xs, pv, q0 + 2 * m + 1, P, C, st)),
        win[m]);
  }
}

// The INT frame starting at E[q0], windowed, in the ladder's first layout:
// register r holds point first_sample(r) = bitrev(lane, 5) + 32 * rev4(r).
template <typename In>
__device__ __forceinline__ void ingest_int(int (&re)[int_stages::kPts],
                                           const int* cs, const In* xs,
                                           int pv, int q0, int P, int C,
                                           const Strides& st,
                                           const volatile int* cv) {
  const int b = int_stages::bitrev(int_stages::lane(), 5);
#pragma unroll
  for (int r = 0; r < int_stages::kPts; ++r) {
    const int p = b + 32 * int_stages::rev4(r);
    re[r] = int_stages::window(
        emph_int(cs, xs, pv, q0 + p, P, C, st), cv[p]);
  }
}

// st with unit carry and chunk position strides.  Passed to an inlined
// ingest, the constants take the place of a 64-bit stride multiply a point
// (PERF.md measures what that saves on an H100 at the serving shape).
__device__ __forceinline__ Strides unit_positions(Strides st) {
  st.carry_p = 1;
  st.chunk_t = 1;
  return st;
}

// A frame's first E index, P - count + g * hop, held in [-nfft, P + C] so
// that the indices of its points stay in int range (shape_ok bounds C).
__device__ __forceinline__ int frame_start(int P, int count, int g, int hop,
                                           int C) {
  const long long q0 = static_cast<long long>(P - count) +
                       static_cast<long long>(g) * hop;
  return static_cast<int>(q0 < -1024 ? -1024 : q0 > P + C ? P + C : q0);
}

// Stream s's count and prev with its reset merged.
template <typename T>
__device__ __forceinline__ void stream_in(const StepState<T>& io, int s,
                                          int& count, T& prev) {
  const bool reset = io.reset != nullptr && io.reset[s] != 0;
  count = reset ? 0 : io.count[s];
  prev = reset ? T(0) : io.prev[s];
}

// The outputs besides the features that the warp on frame slot g of stream
// s writes (G = s*F + g): carry positions [g * share, (g + 1) * share) of
// E[C + p], share = ceil(P / F), its lanes striding by 32; lane 0 mask[G]
// and, on slot 0, the new count and the new prev (the chunk's last raw
// sample xs[C - 1]).
template <typename T, typename In, typename E>
__device__ __forceinline__ void step_outputs(const StepState<T>& io,
                                             T* __restrict__ nc, const In* xs,
                                             int s, int G, int g,
                                             int count, int P, int C, int F,
                                             int hop, const Strides& st,
                                             E emph) {
  const int share = (P + F - 1) / F;
  const int p1 = min(P, (g + 1) * share);
  for (int p = g * share + (threadIdx.x & 31); p < p1; p += 32)
    nc[s * st.ncarry_s + p * st.ncarry_p] = emph(C + p);
  if ((threadIdx.x & 31) == 0) {
    const int total = count + C;
    const int n_valid = max(floor_div(total - (P + 1), hop) + 1, 0);
    io.mask[G] = g < n_valid;
    if (g == 0) {
      io.ncount[s] = total - n_valid * hop;
      io.nprev[s] = static_cast<T>(xs[static_cast<long long>(C - 1) * st.chunk_t]);
    }
  }
}

// -- The staged window (the main path) ---------------------------------------

// A tile: a block's frame slots, one a warp.
constexpr int kSlots = 8;
static_assert(kSlots == fladder_stages::kFrames &&
              kSlots == int_stages::kFrames, "one frame slot a warp");
// Bytes of one of a block's two row buffers: what keeps 3 blocks an SM in
// the SM's 233,472 bytes (1,024 reserved a block) beside the float block's
// 53,232 bytes of K1's arrays and the INT block's 32,880 of K3's.
constexpr int kRowsF32 = 11776;
constexpr int kRowsInt = 21952;

__host__ __device__ constexpr long long align16(long long n) {
  return (n + 15) & ~15LL;
}

// The most streams a tile's kSlots slots span: ceil((kSlots - 1) / F) + 1.
__host__ __device__ inline int tile_streams(int F) {
  const int n = (kSlots - 2 + F) / F + 1;
  return n < kSlots ? n : kSlots;
}

// A row buffer, for tiles of at most n streams: their carry rows (P values
// of 4 bytes each) and their chunk rows (C samples of in_bytes each), each
// a run of rows back to back copied as the aligned 16-byte blocks that
// cover it (at most 30 bytes more), then kStateBytes of state: kSlots
// counts, kSlots prevs and the (at most 3) words holding the tile's reset
// flags.
constexpr int kStateBytes = 8 * kSlots + 16;
struct RowsLayout {
  int chunk, state;   // byte offsets of the chunk rows and the state
  long long bytes;    // the buffer's bytes
  __host__ __device__ RowsLayout(int n, int P, int C, int in_bytes) {
    const long long c = align16(4LL * P * n + 31);
    const long long x = align16(static_cast<long long>(in_bytes) * C * n + 31);
    bytes = c + x + kStateBytes;
    chunk = static_cast<int>(c < (1LL << 30) ? c : 0);
    state = static_cast<int>(c + x < (1LL << 30) ? c + x : 0);
  }
};

// Whether a step takes the staged window: the carry and the chunk are the
// (S, P) carry and (S, C) chunk, rows of unit position stride back to back,
// and the rows of a tile's streams fit a row buffer of `buffer` bytes.
// ops/stream_fused.py staged mirrors it.
inline bool staged(int F, int P, int C, int in_bytes, int buffer,
                   const Strides& st) {
  return st.carry_p == 1 && st.chunk_t == 1 && st.carry_s == P &&
         st.chunk_s == C && F >= 1 &&
         RowsLayout(tile_streams(F), P, C, in_bytes).bytes <= buffer;
}

// Frames a stream of count buffered samples completes with a C-sample
// chunk: an explicit floor division.
__device__ __forceinline__ int valid_frames(int count, int P, int C,
                                            int hop) {
  return max(floor_div(count + C - (P + 1), hop) + 1, 0);
}

// Tile t: slots [G0, G1) of the flat (stream, slot) list, over streams s0
// .. s0 + ns - 1; stream i of them holds its slots from ga(i) on here.
struct Tile {
  int G0, G1, s0, ns, F;
  __device__ __forceinline__ Tile(int t, int M, int F_)
      : G0(t * kSlots), G1(min(t * kSlots + kSlots, M)), s0(G0 / F_),
        ns((G1 - 1) / F_ - G0 / F_ + 1), F(F_) {}
  __device__ __forceinline__ int ga(int i) const {
    return max(G0 - (s0 + i) * F, 0);
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// A pointer's aligned 2^k-byte block and its byte offset in it.
template <int kAlign, typename X>
__device__ __forceinline__ const char* block_of(const X* p) {
  return reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) &
                                       ~uintptr_t(kAlign - 1));
}
template <int kAlign, typename X>
__device__ __forceinline__ int byte_in_block(const X* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & (kAlign - 1));
}

// The block's copies of `bytes` bytes from p into dst as the aligned
// 16-byte blocks that cover them (the first at dst): whole aligned blocks
// around the run, never outside its pages.
__device__ __forceinline__ void run_issue(char* dst, const void* p,
                                          long long bytes) {
  const char* a = block_of<16>(static_cast<const char*>(p));
  const int n = static_cast<int>((byte_in_block<16>(static_cast<const char*>(p)) +
                                  bytes + 15) / 16);
  for (int k = threadIdx.x; k < n; k += kSlots * 32)
    cp_async16(dst + 16 * k, a + 16 * k);
}

// The block's copies of tile tl's streams into a row buffer (RowsLayout):
// their carry rows and chunk rows, each a run of global memory (the tile's
// streams are consecutive rows), and their counts, prevs and reset words,
// issued as one cp.async group that nothing waits for here.
template <typename T, typename In>
__device__ __forceinline__ void rows_issue(char* buf, const RowsLayout& lay,
                                           const Tile& tl,
                                           const T* __restrict__ carry,
                                           const In* __restrict__ chunk,
                                           const StepState<T>& io, int P,
                                           int C) {
  run_issue(buf, carry + static_cast<long long>(tl.s0) * P,
            4LL * P * tl.ns);
  run_issue(buf + lay.chunk, chunk + static_cast<long long>(tl.s0) * C,
            static_cast<long long>(sizeof(In)) * C * tl.ns);
  char* sb = buf + lay.state;
  const int i = threadIdx.x;
  if (i < tl.ns) {
    cp_async4(sb + 4 * i, io.count + tl.s0 + i);
    cp_async4(sb + 4 * (kSlots + i), io.prev + tl.s0 + i);
  } else if (i >= kSlots && io.reset != nullptr &&
             i - kSlots < (byte_in_block<4>(io.reset + tl.s0) + tl.ns + 3) / 4) {
    const int k = i - kSlots;
    cp_async4(sb + 4 * (2 * kSlots + k), block_of<4>(io.reset + tl.s0) + 4 * k);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Stream i's rows in a row buffer: its carry row c[0, P) and chunk row x[0,
// C) (x[-1] is readable: the block before, or the stream before's last
// sample), and its count and prev with the reset merged.
template <typename T, typename In>
struct Rows {
  const T* c;
  const In* x;
  int count;
  T prev;
};

template <typename T, typename In>
__device__ __forceinline__ Rows<T, In> rows_of(const char* buf,
                                               const RowsLayout& lay, int i,
                                               const Tile& tl, const T* carry,
                                               const In* chunk,
                                               const StepState<T>& io, int P,
                                               int C) {
  const char* sb = buf + lay.state;
  const int* count = reinterpret_cast<const int*>(sb);
  bool reset = false;
  if (io.reset != nullptr)
    reset = sb[4 * 2 * kSlots + byte_in_block<4>(io.reset + tl.s0) + i] != 0;
  Rows<T, In> w;
  w.c = reinterpret_cast<const T*>(
            buf + byte_in_block<16>(carry + static_cast<long long>(tl.s0) * P)) +
        i * P;
  w.x = reinterpret_cast<const In*>(
            buf + lay.chunk +
            byte_in_block<16>(chunk + static_cast<long long>(tl.s0) * C)) +
        i * C;
  w.count = reset ? 0 : count[i];
  w.prev = reset ? T(0) : reinterpret_cast<const T*>(sb + 4 * kSlots)[i];
  return w;
}

// E[q] of a stream from its rows (emph(x, p): the emphasized sample from
// it and the one before): predicated reads of the carry row or the chunk
// row, 0 outside [0, P + C).
template <typename T, typename In, typename Emph>
__device__ __forceinline__ T e_at(const Rows<T, In>& w, int q, int P, int C,
                                  Emph emph) {
  const bool inc = q >= 0 && q < P;
  const bool inx = q >= P && q < P + C;
  const T c = inc ? w.c[q] : T(0);
  const T x = inx ? static_cast<T>(w.x[q - P]) : T(0);
  const T p = inx && q > P ? static_cast<T>(w.x[q - P - 1]) : w.prev;
  return inc ? c : inx ? emph(x, p) : T(0);
}

// The float frame starting at E[q0] from a stream's rows, as ingest_f32: a
// frame wholly inside the chunk reads three samples a pair at constant
// offsets from the lane's base, any other each point by e_at.
template <int LOG2P, typename In>
__device__ __forceinline__ void rows_f32(double2 (&z)[1 << LOG2P],
                                         const Rows<float, In>& w, int q0,
                                         int P, int C, const double2* win,
                                         int l) {
  const auto emph = [](float x, float p) {
    return __fsub_rn(x, __fmul_rn(kEmphF, p));
  };
  constexpr int kN = 64 << LOG2P;
  const int t0 = q0 - P;
  if (t0 >= 1 && t0 + kN <= C) {
    const In* x = w.x + t0 + 2 * l;
#pragma unroll
    for (int r = 0; r < (1 << LOG2P); ++r) {
      const In* y = x + 64 * r;
      const float p = to_f32(y[-1]), a = to_f32(y[0]), b = to_f32(y[1]);
      z[r] = fladder_stages::window_pair(static_cast<double>(emph(a, p)),
                                         static_cast<double>(emph(b, a)),
                                         win[l + 32 * r]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < (1 << LOG2P); ++r) {
    const int m = l + 32 * r;
    z[r] = fladder_stages::window_pair(
        static_cast<double>(e_at(w, q0 + 2 * m, P, C, emph)),
        static_cast<double>(e_at(w, q0 + 2 * m + 1, P, C, emph)), win[m]);
  }
}

// The INT frame starting at E[q0] from a stream's rows, windowed, in the
// ladder's first layout (as ingest_int); the same two cases as rows_f32.
template <typename In>
__device__ __forceinline__ void rows_int(int (&re)[int_stages::kPts],
                                         const Rows<int, In>& w, int q0,
                                         int P, int C,
                                         const volatile int* cv) {
  const auto emph = [](int x, int p) { return int_stages::preemph32(x, p); };
  const int b = int_stages::bitrev(int_stages::lane(), 5);
  const int t0 = q0 - P;
  if (t0 >= 1 && t0 + int_stages::kNfft <= C) {
    const In* x = w.x + t0 + b;
#pragma unroll
    for (int r = 0; r < int_stages::kPts; ++r) {
      const int p = 32 * int_stages::rev4(r);
      re[r] = int_stages::window(
          emph(static_cast<int>(x[p]), static_cast<int>(x[p - 1])),
          cv[b + p]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < int_stages::kPts; ++r) {
    const int p = b + 32 * int_stages::rev4(r);
    re[r] = int_stages::window(e_at(w, q0 + p, P, C, emph), cv[p]);
  }
}

// Each block walks tiles t = blockIdx.x, + gridDim.x, ... of kSlots
// slots.  The rows of a tile's streams are copied (rows_issue) into one of
// the block's two row buffers while the tile before runs; after one
// barrier a tile (its rows are in, the tile before's buffer is read) the
// block issues the next tile's copies, then thread i of a stream whose
// slot 0 is here writes its new count and prev, the block its new carry
// E[C : C+P), and warp w takes slot G = t * kSlots + w as the per-point
// kernels do: its mask entry, then `slot(G, rows, q0)` on its frame
// starting at E[q0].
template <typename T, typename In, typename Emph, typename Slot>
__device__ __forceinline__ void staged_walk(char* rows, int buffer,
                                            const StepState<T>& io,
                                            const T* carry, const In* chunk,
                                            T* ncarry, int M, int P, int C,
                                            int F, int hop,
                                            const Strides& st, Emph emph,
                                            Slot slot) {
  const int tiles = (M + kSlots - 1) / kSlots;
  const RowsLayout lay(tile_streams(F), P, C, sizeof(In));
  if (static_cast<int>(blockIdx.x) < tiles)
    rows_issue(rows, lay, Tile(blockIdx.x, M, F), carry, chunk, io, P, C);
  int par = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, par ^= 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // the tile's rows are in; the tile before's are read
    const int tn = t + static_cast<int>(gridDim.x);
    if (tn < tiles)
      rows_issue(rows + (par ^ 1) * buffer, lay, Tile(tn, M, F), carry,
                 chunk, io, P, C);
    const char* buf = rows + par * buffer;
    const Tile tl(t, M, F);
    for (int i = 0; i < tl.ns; ++i) {
      if (tl.ga(i) != 0) continue;   // slot 0 is in an earlier tile
      const long long s = tl.s0 + i;
      const Rows<T, In> w = rows_of(buf, lay, i, tl, carry, chunk, io, P, C);
      if (threadIdx.x == i) {
        io.ncount[s] = w.count + C - valid_frames(w.count, P, C, hop) * hop;
        io.nprev[s] = static_cast<T>(w.x[C - 1]);
      }
      T* nc = ncarry + s * st.ncarry_s;
      if (C > P) {   // E[C + p] = emph(x[C + p - P], x[C + p - P - 1])
        for (int p = threadIdx.x; p < P; p += kSlots * 32)
          nc[p * st.ncarry_p] = emph(static_cast<T>(w.x[C - P + p]),
                                     static_cast<T>(w.x[C - P + p - 1]));
      } else {
        for (int p = threadIdx.x; p < P; p += kSlots * 32)
          nc[p * st.ncarry_p] = e_at(w, C + p, P, C, emph);
      }
    }
    const int G = tl.G0 + static_cast<int>(threadIdx.x) / 32;
    if (G < tl.G1) {
      const int i = G / F - tl.s0;
      const int g = G - (tl.s0 + i) * F;
      const Rows<T, In> w = rows_of(buf, lay, i, tl, carry, chunk, io, P, C);
      if ((threadIdx.x & 31) == 0)
        io.mask[G] = g < valid_frames(w.count, P, C, hop);
      slot(G, w, frame_start(P, w.count, g, hop, C));
    }
  }
}

template <typename In>
__global__ void __launch_bounds__(fladder_stages::kThreads, kFloatResident)
stream_f32_kernel(const float* __restrict__ carry, const In* __restrict__ chunk,
                  StepState<float> io, float* __restrict__ out,
                  float* __restrict__ ncarry, int M, int P, int C, int F,
                  int hop, int nfilters, int ncep, Strides st,
                  const double2* __restrict__ win, const double2* __restrict__ tw,
                  const double* __restrict__ mel, const double* __restrict__ dct,
                  const int2* __restrict__ band,
                  const double2* __restrict__ msched, int msteps,
                  double mel_floor) {
  using namespace fladder_stages;
  extern __shared__ double2 smem[];
  constexpr int LOG2P = kLog2P;
  constexpr int log2m = 5 + LOG2P;
  constexpr int kP = 1 << LOG2P;
  const Smem sm = carve(smem, log2m + 1, msteps);
  load_constants(sm, log2m + 1, tw, mel, band, msched, nfilters);
  // the row buffers past K1's arrays (smem_bytes(nfft) bytes: the mel
  // table last); the walk's first barrier follows the tables' stores
  char* rows = reinterpret_cast<char*>(sm.melt + kMelPerPoint * sm.R);
  const int l = lane();
  staged_walk(rows, kRowsF32, io, carry, chunk, ncarry, M, P, C, F, hop,
              unit_positions(st),
              [](float x, float p) { return __fsub_rn(x, __fmul_rn(kEmphF, p)); },
              [&](int G, const Rows<float, In>& w, int q0) {
                double2 z[kP];
                rows_f32<LOG2P>(z, w, q0, P, C, win, l);
                ladder_tail<LOG2P>(z, sm, nfilters, ncep, mel, dct, band,
                                   mel_floor,
                                   out + static_cast<long long>(G) * ncep);
              });
}

template <typename In>
__global__ void __launch_bounds__(fladder_stages::kThreads, kFloatResident)
stream_f32_pointwise_kernel(const float* __restrict__ carry, const In* __restrict__ chunk,
                  StepState<float> io, float* __restrict__ out,
                  float* __restrict__ ncarry, int M, int P, int C, int F,
                  int hop, int nfilters, int ncep, Strides st,
                  const double2* __restrict__ win, const double2* __restrict__ tw,
                  const double* __restrict__ mel, const double* __restrict__ dct,
                  const int2* __restrict__ band,
                  const double2* __restrict__ msched, int msteps,
                  double mel_floor) {
  using namespace fladder_stages;
  extern __shared__ double2 smem[];
  constexpr int LOG2P = kLog2P;
  constexpr int log2m = 5 + LOG2P;
  constexpr int kP = 1 << LOG2P;
  const Smem sm = carve(smem, log2m + 1, msteps);
  load_constants(sm, log2m + 1, tw, mel, band, msched, nfilters);
  __syncthreads();

  // each warp takes frame slots G = s * F + g in a grid-stride loop, in
  // 32-bit indices (the launch checks M < 2^30)
  const int l = lane();
  for (int G = static_cast<int>(blockIdx.x) * kFrames + threadIdx.x / kLanes;
       G < M; G += static_cast<int>(gridDim.x) * kFrames) {
    const int s = G / F;
    const int g = G - s * F;
    const float* cs = carry + s * st.carry_s;
    const In* xs = chunk + s * st.chunk_s;
    int count;
    float pv;
    stream_in(io, s, count, pv);
    step_outputs(io, ncarry, xs, s, G, g, count, P, C, F, hop, st,
                 [&](int q) { return emph_f32(cs, xs, pv, q, P, C, st); });
    // E at sample pairs, window * 1/nfft, packed z[m] = y[2m] + i*y[2m+1],
    // lane l's register r holding z[l + 32r]
    const int q0 = frame_start(P, count, g, hop, C);
    double2 z[kP];
    if (st.carry_p == 1 && st.chunk_t == 1)
      ingest_f32<LOG2P>(z, cs, xs, pv, q0, P, C, unit_positions(st), win, l);
    else
      ingest_f32<LOG2P>(z, cs, xs, pv, q0, P, C, st, win, l);
    ladder_tail<LOG2P>(z, sm, nfilters, ncep, mel, dct, band, mel_floor,
                       out + static_cast<long long>(G) * ncep);
  }
}

// The split-DFT float step: K4-float's ingest (the same f32 emphasized
// values and the same new carry) in front of K5's tail, on K5's persistent
// grid over the flattened (S x F) frame slots.  The new carry of
// stream s is written by the tile that holds its frame slot 0.
template <typename In, int PASSES, int CT, int NT>
__global__ void __launch_bounds__(dmma_product::kThreads, 1)
stream_r2_kernel(radix2_stages::Geometry geo, long long M,
                 const dmma_product::OpT* __restrict__ op,
                 const float* __restrict__ carry, const In* __restrict__ chunk,
                 const int* __restrict__ start, const float* __restrict__ prev,
                 float* __restrict__ out, float* __restrict__ ncarry, int P,
                 int C, int F, int hop, int nfilters, int ncep, Strides st,
                 radix2_stages::Tables tb, float mel_floor) {
  using namespace radix2_stages;
  extern __shared__ __align__(16) unsigned char r2_smem[];
  run<PASSES, CT, NT>(r2_smem, geo, M, op, tb, nfilters, ncep, mel_floor, out,
                      [&](const Smem& sm, long long G0) {
    const int nh = sm.nh, n = sm.FT * nh;
    frame_table(sm, G0, M, F);
    // kU sample pairs a thread in flight: their loads first, then the stores
    for (int i0 = threadIdx.x; i0 < n; i0 += kU * kConsumers) {
      float ye[kU], yo[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kConsumers;
        ye[u] = yo[u] = 0.0f;
        const int2 sg = i < n ? sm.fr[i >> sm.log2nh] : make_int2(-1, 0);
        if (sg.x >= 0) {
          const long long s = sg.x;
          const float* cs = carry + s * st.carry_s;
          const In* xs = chunk + s * st.chunk_s;
          const float pv = prev[s];
          const long long q = start[s] + static_cast<long long>(sg.y) * hop +
                              2 * (i & (nh - 1));
          ye[u] = emph_f32(cs, xs, pv, q, P, C, st);
          yo[u] = emph_f32(cs, xs, pv, q + 1, P, C, st);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kConsumers;
        if (i >= n) break;
        const int f = i >> sm.log2nh, m = i & (nh - 1);
        if (sm.fr[f].x >= 0)
          put_pair<PASSES>(sm, f, m, ye[u], yo[u], tb.we, tb.wo);
        else
          put_zero<PASSES>(sm, f, m);
      }
    }
    // the new carry of the streams whose slot 0 is in this tile
    const long long G1 = G0 + sm.FT < M ? G0 + sm.FT : M;
    const long long s0 = (G0 + F - 1) / F, s1 = (G1 + F - 1) / F;
    for (long long i = threadIdx.x; i < (s1 - s0) * P; i += kConsumers) {
      const long long s = s0 + i / P;
      const int p = static_cast<int>(i - (s - s0) * P);
      ncarry[s * st.ncarry_s + p * st.ncarry_p] = emph_f32(
          carry + s * st.carry_s, chunk + s * st.chunk_s, prev[s],
          static_cast<long long>(C) + p, P, C, st);
    }
    consumer_sync();
  }, [](const Smem&, long long) {});   // the step's input is small and strided
}

template <typename In>
__global__ void __launch_bounds__(int_stages::kThreads, kIntResident)
stream_int_pointwise_kernel(const int* __restrict__ carry, const In* __restrict__ chunk,
                  StepState<int> io, int* __restrict__ out,
                  int* __restrict__ ncarry, int M, int P, int C, int F,
                  int hop, Strides st, const int* __restrict__ curve,
                  const int2* __restrict__ tw, const uint2* __restrict__ sched,
                  int_stages::Tail c) {
  using namespace int_stages;
  __shared__ FbLadderSmem sm;
  load_ladder_tables(sm, tw);
  load_fb_tables(sm.fb, sched, c);
  for (int i = threadIdx.x; i < kNfft; i += blockDim.x) sm.curve[i] = curve[i];
  __syncthreads();
  // the curve is read each frame through a volatile pointer, as in K3
  const volatile int* cv = sm.curve;
  for (int G = static_cast<int>(blockIdx.x) * kFrames + threadIdx.x / kLanes;
       G < M; G += static_cast<int>(gridDim.x) * kFrames) {
    const int s = G / F;
    const int g = G - s * F;
    const int* cs = carry + s * st.carry_s;
    const In* xs = chunk + s * st.chunk_s;
    int count, pv;
    stream_in(io, s, count, pv);
    step_outputs(io, ncarry, xs, s, G, g, count, P, C, F, hop, st,
                 [&](int q) { return emph_int(cs, xs, pv, q, P, C, st); });
    const int q0 = frame_start(P, count, g, hop, C);
    int re[kPts];
    if (st.carry_p == 1 && st.chunk_t == 1)
      ingest_int(re, cs, xs, pv, q0, P, C, unit_positions(st), cv);
    else
      ingest_int(re, cs, xs, pv, q0, P, C, st, cv);
    tail_balanced(re, sm, c, out + static_cast<long long>(G) * c.ncep);
  }
}

template <typename In>
__global__ void __launch_bounds__(int_stages::kThreads, kIntResident)
stream_int_kernel(const int* __restrict__ carry, const In* __restrict__ chunk,
                  StepState<int> io, int* __restrict__ out,
                  int* __restrict__ ncarry, int M, int P, int C, int F,
                  int hop, Strides st, const int* __restrict__ curve,
                  const int2* __restrict__ tw, const uint2* __restrict__ sched,
                  int_stages::Tail c) {
  using namespace int_stages;
  __shared__ FbLadderSmem sm;
  extern __shared__ __align__(16) char int_rows[];
  load_ladder_tables(sm, tw);
  load_fb_tables(sm.fb, sched, c);
  for (int i = threadIdx.x; i < kNfft; i += blockDim.x) sm.curve[i] = curve[i];
  // the curve is read each frame through a volatile pointer, as in K3; the
  // walk's first barrier follows the tables' stores
  const volatile int* cv = sm.curve;
  staged_walk(int_rows, kRowsInt, io, carry, chunk, ncarry, M, P, C, F, hop,
              unit_positions(st),
              [](int x, int p) { return preemph32(x, p); },
              [&](int G, const Rows<int, In>& w, int q0) {
                int re[kPts];
                rows_int(re, w, q0, P, C, cv);
                tail_balanced(re, sm, c, out + static_cast<long long>(G) * c.ncep);
              });
}

// Checks shared by both steps; returns the tiles per stream, or 0 (the
// split-DFT step's grid is K5's over the S*F slots).
long long tiles_for(long long S, int P, int C, int F, int hop, int nfft,
                    int frames_per_tile) {
  if (!shape_ok(S, P, C, F, hop, nfft)) return 0;
  const long long tiles = (F + frames_per_tile - 1) / frames_per_tile;
  if (S * tiles > 0x7fffffffLL) return 0;
  return tiles;
}

template <typename In>
int launch_f32(const float* carry, const In* chunk, const StepState<float>& io,
               float* out, float* ncarry, long long S, int P, int C, int F,
               int hop, int nfft, int nfilters, int ncep, const Strides& st,
               const double* win, const double* tw, const double* mel,
               const double* dct, const int* band, const void* msched,
               int msteps, double mel_floor, void* stream) {
  using namespace fladder_stages;
  if (nfft != 64 << kLog2P || !shape_ok(S, P, C, F, hop, nfft) ||
      !state_ok(io) || nfilters < 1 || nfilters > nfft / 2 || ncep < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  if (S * F >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int M = static_cast<int>(S * F);
  const bool window = staged(F, P, C, sizeof(In), kRowsF32, st);
  return launch_persistent(
      window ? stream_f32_kernel<In> : stream_f32_pointwise_kernel<In>,
      kThreads, (M + kFrames - 1) / kFrames,
      smem_bytes(nfft) + (window ? 2 * kRowsF32 : 0), stream, carry,
      chunk, io, out, ncarry, M, P, C, F, hop, nfilters, ncep, st,
      reinterpret_cast<const double2*>(win),
      reinterpret_cast<const double2*>(tw), mel, dct,
      reinterpret_cast<const int2*>(band),
      static_cast<const double2*>(msched), mel_steps(msched, msteps, nfft),
      mel_floor);
}

template <typename In>
int launch_step_r2(const float* carry, const In* chunk, const int* start,
                   const float* prev, float* out, float* ncarry, long long S,
                   int P, int C, int F, int hop, int nfft, int nfilters,
                   int ncep, const Strides& st, int passes,
                   const dmma_product::Operator& o,
                   const radix2_stages::Tables& tb, double mel_floor,
                   void* stream) {
  using namespace radix2_stages;
  if (!geometry_ok(nfft, passes, nfilters, ncep) ||
      tiles_for(S, P, C, F, hop, nfft, 1) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float fl = static_cast<float>(mel_floor);
  return dispatch(passes, nfft, [&](auto p, auto ct, auto nt) {
    return launch_r2(stream_r2_kernel<In, decltype(p)::value,
                                      decltype(ct)::value, decltype(nt)::value>,
                     S * F, nfft, nfilters, ncep, passes, o, tb, stream, carry,
                     chunk, start, prev, out, ncarry, P, C, F, hop, nfilters,
                     ncep, st, tb, fl);
  });
}

template <typename In>
int launch_int(const int* carry, const In* chunk, const StepState<int>& io,
               int* out, int* ncarry, long long S, int P, int C, int F,
               int hop, const Strides& st, int nfilters, int ncep,
               int fb_shift, int log_precision, int log_width,
               const int* curve, const int* tw, const int* dtw,
               const int* sched, void* stream) {
  using namespace int_stages;
  const Tail c = make_tail(dtw, nfilters, ncep, fb_shift, log_precision,
                           log_width);
  if (!tail_ok(c) || !shape_ok(S, P, C, F, hop, kNfft) || !state_ok(io))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  if (S * F >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int M = static_cast<int>(S * F);
  const bool window = staged(F, P, C, sizeof(In), kRowsInt, st);
  return launch_persistent(
      window ? stream_int_kernel<In> : stream_int_pointwise_kernel<In>,
      kThreads, (M + kFrames - 1) / kFrames,
      window ? 2 * kRowsInt : 0, stream, carry, chunk, io, out, ncarry,
      M, P, C, F, hop, st, curve, reinterpret_cast<const int2*>(tw),
      reinterpret_cast<const uint2*>(sched), c);
}

}  // namespace

// C entry points, bound with ctypes (mfcc_tpu_torch/kernels/build.py).
// Every pointer is a device pointer.  carry and ncarry (new carry, which
// must not overlap carry) hold S x P values and chunk S x C, each addressed
// through its (stream, position) element strides.  The state operands, all
// (S,) and contiguous: count int32; reset bool or null (no reset); prev f32
// for the float step, int32 for the INT step; then out (S, F, ncep)
// contiguous, mask (S, F) bool, ncount (S,) int32 and nprev (S,) in prev's
// dtype.  The tables are K1's (window/nfft, twiddles, mel, dct, band, the
// mel schedule and its steps: see fladder.cu) for the float step and K3's
// (curve, tw, dtw, the balanced filterbank's schedule sched: see
// int_mfcc.cu) for the INT step.
// Launches on `stream`, on the calling thread's current device (the caller
// sets it), without synchronizing; returns a cudaError_t (0 = launched).
extern "C" int mfcc_stream_f32_i16(const float* carry, const int16_t* chunk,
                      const int* count, const unsigned char* reset,
                      const float* prev, float* out, unsigned char* mask,
                      float* ncarry, int* ncount, float* nprev, long long S,
                      int P, int C, int F, int hop, int nfft, int nfilters,
                      int ncep, long long carry_s, long long carry_p,
                      long long chunk_s, long long chunk_t, long long ncarry_s,
                      long long ncarry_p, const double* win, const double* tw,
                      const double* mel, const double* dct, const int* band,
                      const void* msched, int msteps, double mel_floor,
                      void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  const StepState<float> io{count, reset, prev, mask, ncount, nprev};
  return launch_f32(carry, chunk, io, out, ncarry, S, P, C, F, hop, nfft,
                    nfilters, ncep, st, win, tw, mel, dct, band, msched,
                    msteps, mel_floor, stream);
}

extern "C" int mfcc_stream_f32_f32(const float* carry, const float* chunk,
                      const int* count, const unsigned char* reset,
                      const float* prev, float* out, unsigned char* mask,
                      float* ncarry, int* ncount, float* nprev, long long S,
                      int P, int C, int F, int hop, int nfft, int nfilters,
                      int ncep, long long carry_s, long long carry_p,
                      long long chunk_s, long long chunk_t, long long ncarry_s,
                      long long ncarry_p, const double* win, const double* tw,
                      const double* mel, const double* dct, const int* band,
                      const void* msched, int msteps, double mel_floor,
                      void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  const StepState<float> io{count, reset, prev, mask, ncount, nprev};
  return launch_f32(carry, chunk, io, out, ncarry, S, P, C, F, hop, nfft,
                    nfilters, ncep, st, win, tw, mel, dct, band, msched,
                    msteps, mel_floor, stream);
}


// The split-DFT float step: carry, chunk, start, prev, out, ncarry, S, P,
// C, F, hop, nfft, nfilters, ncep and the strides as in mfcc_stream_f32_*,
// then passes (3, 4 or 6), the engine's operator (op, op_rows, chunk_rows)
// and K5's tables (we, wo, tw, melw, moff, dct, band, mel_len: see
// float_fused.cu).
extern "C" int mfcc_stream_r2_i16(const float* carry, const int16_t* chunk, const int* start,
                      const float* prev, float* out, float* ncarry, long long S,
                      int P, int C, int F, int hop, int nfft, int nfilters,
                      int ncep, long long carry_s, long long carry_p,
                      long long chunk_s, long long chunk_t, long long ncarry_s,
                      long long ncarry_p, int passes, const void* op,
                      int op_rows, int chunk_rows, const float* we,
                      const float* wo,
                      const float* tw, const float* melw, const int* moff,
                      const float* dct, const int* band, int mel_len,
                      double mel_floor, void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  const dmma_product::Operator o{op, op_rows, chunk_rows};
  const radix2_stages::Tables tb{we, wo, tw, melw, moff, dct, band,
                                 mel_len};
  return launch_step_r2(carry, chunk, start, prev, out, ncarry, S, P, C, F,
                        hop, nfft, nfilters, ncep, st, passes, o, tb,
                        mel_floor, stream);
}

extern "C" int mfcc_stream_r2_f32(const float* carry, const float* chunk, const int* start,
                      const float* prev, float* out, float* ncarry, long long S,
                      int P, int C, int F, int hop, int nfft, int nfilters,
                      int ncep, long long carry_s, long long carry_p,
                      long long chunk_s, long long chunk_t, long long ncarry_s,
                      long long ncarry_p, int passes, const void* op,
                      int op_rows, int chunk_rows, const float* we,
                      const float* wo,
                      const float* tw, const float* melw, const int* moff,
                      const float* dct, const int* band, int mel_len,
                      double mel_floor, void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  const dmma_product::Operator o{op, op_rows, chunk_rows};
  const radix2_stages::Tables tb{we, wo, tw, melw, moff, dct, band,
                                 mel_len};
  return launch_step_r2(carry, chunk, start, prev, out, ncarry, S, P, C, F,
                        hop, nfft, nfilters, ncep, st, passes, o, tb,
                        mel_floor, stream);
}

extern "C" int mfcc_stream_int_i16(const int* carry, const int16_t* chunk,
                      const int* count, const unsigned char* reset,
                      const int* prev, int* out, unsigned char* mask,
                      int* ncarry, int* ncount, int* nprev, long long S, int P,
                      int C, int F, int hop, long long carry_s,
                      long long carry_p, long long chunk_s, long long chunk_t,
                      long long ncarry_s, long long ncarry_p, int nfilters,
                      int ncep, int fb_shift, int log_precision, int log_width,
                      const int* curve, const int* tw, const int* dtw,
                      const int* sched, void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  const StepState<int> io{count, reset, prev, mask, ncount, nprev};
  return launch_int(carry, chunk, io, out, ncarry, S, P, C, F, hop, st,
                    nfilters, ncep, fb_shift, log_precision, log_width, curve,
                    tw, dtw, sched, stream);
}

extern "C" int mfcc_stream_int_i32(const int* carry, const int* chunk,
                      const int* count, const unsigned char* reset,
                      const int* prev, int* out, unsigned char* mask,
                      int* ncarry, int* ncount, int* nprev, long long S, int P,
                      int C, int F, int hop, long long carry_s,
                      long long carry_p, long long chunk_s, long long chunk_t,
                      long long ncarry_s, long long ncarry_p, int nfilters,
                      int ncep, int fb_shift, int log_precision, int log_width,
                      const int* curve, const int* tw, const int* dtw,
                      const int* sched, void* stream) {
  const Strides st{carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p};
  const StepState<int> io{count, reset, prev, mask, ncount, nprev};
  return launch_int(carry, chunk, io, out, ncarry, S, P, C, F, hop, st,
                    nfilters, ncep, fb_shift, log_precision, log_width, curve,
                    tw, dtw, sched, stream);
}

// 1 where a step of F frame slots over a C-sample chunk of in_bytes
// samples (P = nfft - 1), its carry and chunk read with these element
// strides, takes the staged window of the float step (int_step 0) or the
// INT step (1), else 0 (the per-point kernels): the launches' own test,
// for the wrapper's mirror.
extern "C" int mfcc_stream_staged(int int_step, int F, int C, int nfft,
                                  int in_bytes, long long carry_s,
                                  long long carry_p, long long chunk_s,
                                  long long chunk_t) {
  return staged(F, nfft - 1, C, in_bytes, int_step ? kRowsInt : kRowsF32,
                Strides{carry_s, carry_p, chunk_s, chunk_t, 0, 1}) ? 1 : 0;
}
