// The FP64 tensor cores' rate on this card, as the product engine
// (csrc/dmma_product.cuh) feeds them: 8 warps a block, one block per SM,
// every warp issuing mma.sync .f64 on 16 (4 column tiles x 4 signal tiles,
// K8's warp tile) or 16 (2 x 8, K5's) independent accumulators.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o dmma_rate \
//        mfcc_tpu_torch/tools/dmma_rate.cu && ./dmma_rate
//
// Prints one line per case, TFLOP/s counting 2 operations per multiply-add:
//   shape m16n8k4 / k8 / k16, operands from registers; the same with one
//   f32 -> f64 conversion per MMA (the engine's A fragments are f32);
//   m16n8k8 fed from shared memory every step as the engine feeds it:
//   mode 1 A as f32 (LDS.128, converted) and B as rows (two LDS.64 a
//   signal tile), mode 2 A as f64 (two LDS.128, no conversion), mode 3 B
//   by one LDS.128 a signal tile.  No synchronisation between steps: the
//   gap between these rates and the engine's is what its ring costs.

#include <cstdio>

#include <cuda_runtime.h>

namespace {

template <int KS>
__device__ __forceinline__ void mma(double (&d)[4], const double* a, const double* b);

template <>
__device__ __forceinline__ void mma<4>(double (&d)[4], const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, "
      "{%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

template <>
__device__ __forceinline__ void mma<8>(double (&d)[4], const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

template <>
__device__ __forceinline__ void mma<16>(double (&d)[4], const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Operands from registers; CONV converts one f32 value into A per MMA.
template <int KS, int CONV>
__global__ void __launch_bounds__(256, 1) from_registers(double* out, const float* src,
                                                         int iters) {
  double acc[16][4];
  for (int i = 0; i < 16; ++i)
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0;
  double a[KS / 2], b[KS / 4];
  for (int i = 0; i < KS / 2; ++i) a[i] = 1.0 + threadIdx.x * 1e-3 + i;
  for (int i = 0; i < KS / 4; ++i) b[i] = 0.5 + i;
  float f = src[threadIdx.x];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (CONV) {
        a[0] = static_cast<double>(f + j);
        f += 1.0f;
      }
      mma<KS>(acc[j], a, b);
    }
  }
  double s = 0;
  for (int i = 0; i < 16; ++i)
    for (int c = 0; c < 4; ++c) s += acc[i][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// m16n8k8 fed from shared memory every step (MODE as in the header),
// CT column tiles x NT signal tiles a warp, B rows of RS doubles.
template <int CT, int NT, int MODE, int RS = (NT == 8 ? 260 : 516)>
__global__ void __launch_bounds__(256, 1) from_shared(double* out, int iters) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* A = reinterpret_cast<float*>(sm);             // 8 warps x CT x 32 x 4
  double* B = reinterpret_cast<double*>(sm + 32768);   // NT * 8 rows x RS
  for (int i = threadIdx.x; i < 8192; i += 256) A[i] = 1.0f + (i & 7);
  for (int i = threadIdx.x; i < NT * 8 * RS; i += 256) B[i] = 0.5 + (i & 3);
  __syncthreads();
  double acc[CT][NT][4];
  for (int j = 0; j < CT; ++j)
    for (int n = 0; n < NT; ++n)
      for (int c = 0; c < 4; ++c) acc[j][n][c] = 0;
  double a[CT][4], b[NT][2];
  const int g = lane >> 2, t = lane & 3;
  for (int it = 0; it < iters; ++it) {
    const int k0 = (it & 31) * 8;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (MODE == 3) {
        const double2 v =
            reinterpret_cast<const double2*>(B)[((n * 64 + (it & 31)) * 32 + lane) & 8191];
        b[n][0] = v.x;
        b[n][1] = v.y;
      } else {
        b[n][0] = B[(n * 8 + g) * RS + k0 + t];
        b[n][1] = B[(n * 8 + g) * RS + k0 + t + 4];
      }
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      if (MODE == 2) {
        const double2* p = reinterpret_cast<const double2*>(sm) + ((warp * CT + j) * 32 + lane) * 2;
        const double2 v = p[0], w = p[1];
        a[j][0] = v.x; a[j][1] = v.y; a[j][2] = w.x; a[j][3] = w.y;
      } else {
        const float4 v = reinterpret_cast<const float4*>(A)[(warp * CT + j) * 32 + lane];
        a[j][0] = v.x; a[j][1] = v.y; a[j][2] = v.z; a[j][3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n) mma<8>(acc[j][n], a[j], b[n]);
  }
  double s = 0;
  for (int j = 0; j < CT; ++j)
    for (int n = 0; n < NT; ++n)
      for (int c = 0; c < 4; ++c) s += acc[j][n][c];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

// TFLOP/s of `launch(iters)` over `flops(iters)`, after a short warm-up.
template <typename Launch>
double rate(Launch launch, double flops_per_iter) {
  const int iters = 2000;
  launch(10);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  launch(iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return flops_per_iter * iters / ms / 1e9;
}

template <int KS, int CONV>
void registers_case(double* out, const float* src, int sms) {
  const double flops = 2.0 * 16 * 8 * KS * 16.0 * 8 * sms;   // 16 MMAs a warp a step
  const double tf = rate([&](int n) { from_registers<KS, CONV><<<sms, 256>>>(out, src, n); },
                         flops);
  printf("m16n8k%d from registers, %s: %.2f TFLOP/s (%s)\n", KS,
         CONV ? "one f32 -> f64 conversion per MMA" : "no conversion", tf,
         cudaGetErrorString(cudaGetLastError()));
}

template <int CT, int NT, int MODE>
void shared_case(double* out, int sms) {
  const int smem = 32768 + NT * 8 * (NT == 8 ? 260 : 516) * 8;
  cudaFuncSetAttribute(from_shared<CT, NT, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const double flops = 2.0 * 16 * 8 * 8 * CT * NT * 8.0 * sms;
  const double tf = rate([&](int n) { from_shared<CT, NT, MODE><<<sms, 256, smem>>>(out, n); },
                         flops);
  printf("m16n8k8 from shared memory, warp tile %d x %d, mode %d: %.2f TFLOP/s (%s)\n",
         CT, NT, MODE, tf, cudaGetErrorString(cudaGetLastError()));
}

}  // namespace

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  double* out;
  float* src;
  cudaMalloc(&out, sms * 256 * sizeof(double));
  cudaMalloc(&src, 4096);
  cudaMemset(src, 0, 4096);
  registers_case<4, 0>(out, src, sms);
  registers_case<8, 0>(out, src, sms);
  registers_case<16, 0>(out, src, sms);
  registers_case<4, 1>(out, src, sms);
  registers_case<8, 1>(out, src, sms);
  shared_case<4, 4, 1>(out, sms);
  shared_case<4, 4, 2>(out, sms);
  shared_case<4, 4, 3>(out, sms);
  shared_case<2, 8, 1>(out, sms);
  shared_case<2, 8, 2>(out, sms);
  shared_case<2, 8, 3>(out, sms);
  cudaFree(out);
  cudaFree(src);
  return 0;
}
