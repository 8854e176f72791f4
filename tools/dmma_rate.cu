// Peak rate of each FP64 tensor-core shape of mma.sync on the card.
//
// Every warp issues 16 independent chains of one shape (operands in
// registers, no memory traffic), 8 warps a block; prints TFLOP/s for
// 1, 2 and 4 blocks per SM. Used to choose the shape of the f64 kernels.
// Build and run on the card's machine, from the root of a checkout:
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/dmma_rate tools/dmma_rate.cu
//   build/dmma_rate
#include <cstdio>

#include <cuda_runtime.h>

template <int SHAPE>
__global__ void __launch_bounds__(256) chains(double* out, int iters) {
  double acc[16][4] = {};
  double a[8], b[4];
  for (int i = 0; i < 8; i++) a[i] = threadIdx.x * 1e-3 + i;
  for (int i = 0; i < 4; i++) b[i] = 1e-3 * (i + 1);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; k++) {
      if (SHAPE == 0)
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1},{%2},{%3},{%0,%1};"
                     : "+d"(acc[k][0]), "+d"(acc[k][1])
                     : "d"(a[0]), "d"(b[0]));
      if (SHAPE == 1)
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5},{%6},"
            "{%0,%1,%2,%3};"
            : "+d"(acc[k][0]), "+d"(acc[k][1]), "+d"(acc[k][2]), "+d"(acc[k][3])
            : "d"(a[0]), "d"(a[1]), "d"(b[0]));
      if (SHAPE == 2)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5,%6,%7},"
            "{%8,%9},{%0,%1,%2,%3};"
            : "+d"(acc[k][0]), "+d"(acc[k][1]), "+d"(acc[k][2]), "+d"(acc[k][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
      if (SHAPE == 3)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},"
            "{%4,%5,%6,%7,%8,%9,%10,%11},{%12,%13,%14,%15},{%0,%1,%2,%3};"
            : "+d"(acc[k][0]), "+d"(acc[k][1]), "+d"(acc[k][2]), "+d"(acc[k][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
              "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
    }
  }
  double s = 0;
  for (int k = 0; k < 16; ++k)
    for (int v = 0; v < 4; ++v) s += acc[k][v];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int SHAPE>
static void run(const char* name, double flops_per_mma, int blocks, double* out) {
  const int iters = 2000;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  chains<SHAPE><<<blocks, 256>>>(out, 10);
  cudaEventRecord(e0);
  chains<SHAPE><<<blocks, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = double(blocks) * 8 * iters * 16 * flops_per_mma;
  printf("dmma_rate %-8s blocks=%d: %.3f ms, %.2f TFLOP/s (%s)\n", name, blocks, ms,
         flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  double* out;
  if (cudaMalloc(&out, size_t(4) * sms * 256 * sizeof(double)) != cudaSuccess) return 1;
  for (int per_sm : {1, 2, 4}) {
    run<0>("m8n8k4", 512, per_sm * sms, out);
    run<1>("m16n8k4", 1024, per_sm * sms, out);
    run<2>("m16n8k8", 2048, per_sm * sms, out);
    run<3>("m16n8k16", 4096, per_sm * sms, out);
  }
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
