// Shared pieces of the hand-written Hopper kernels (sm_90a).
//
// Every kernel of this directory is a short chain of small batched GEMMs.
// They share one block-level building block: `tile_mma` accumulates one
// (BM x BN) output tile of C = A B into per-thread registers, staging
// (BM x BK) and (BK x BN) slices of the operands through shared memory and
// running plain FMA loops on them. Operands are read through small device
// lambdas, so one routine serves row-major, transposed and shared-memory
// operands alike, and every load is bounds-checked (ragged b, r and s need
// no padding on the host).
//
// Element types: double, float and __nv_bfloat16. bf16 accumulates in
// float, as the Pallas kernels accumulate bf16 products in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ double fma_acc(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_acc(float a, float b, float c) { return __fmaf_rn(a, b, c); }

template <typename T> __device__ __forceinline__ T from_acc(typename AccOf<T>::type x);
template <> __device__ __forceinline__ double from_acc<double>(double x) { return x; }
template <> __device__ __forceinline__ float from_acc<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Block tile shape: BM x BN outputs per block, BK-deep shared-memory slices,
// TM x TN outputs per thread. THREADS = (BM / TM) * (BN / TN).
template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct TileCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int TX = BN / TN;       // threads along a tile row
  static constexpr int TY = BM / TM;       // threads along a tile column
  static constexpr int THREADS = TX * TY;
  static constexpr int LDA = BM + 1;       // padded stride of the A slice
  static constexpr int SMEM_A = BK * LDA;  // elements of the A slice
  static constexpr int SMEM_B = BK * BN;   // elements of the B slice
};

// 256 threads each.
using Narrow = TileCfg<64, 16, 16, 4, 1>;   // s = bs = 16 wide outputs
using Wide = TileCfg<64, 64, 16, 4, 4>;     // s = r_max wide outputs
using Tall = TileCfg<128, 16, 16, 8, 1>;    // lr_sample: 128-row blocks

// acc[TM][TN] += A[i0:i0+BM, 0:K] @ B[0:K, j0:j0+BN] for the calling
// thread's TM x TN share of the tile; rows >= M, columns >= N and depth >= K
// load as zero. loadA(i, kk) and loadB(kk, j) return the accumulator type.
// A_K_CONTIG says which index of A is contiguous in memory, so that
// neighbouring threads read neighbouring addresses.
template <class Cfg, bool A_K_CONTIG, typename Acc, class LoadA, class LoadB>
__device__ __forceinline__ void tile_mma(Acc (&acc)[Cfg::TM][Cfg::TN], int i0, int j0,
                                         int M, int N, int K, LoadA loadA, LoadB loadB,
                                         Acc* sA, Acc* sB) {
  const int tid = threadIdx.x;
  const int tx = tid % Cfg::TX;
  const int ty = tid / Cfg::TX;
  for (int k0 = 0; k0 < K; k0 += Cfg::BK) {
    for (int e = tid; e < Cfg::BM * Cfg::BK; e += Cfg::THREADS) {
      int ii, kk;
      if (A_K_CONTIG) {
        kk = e % Cfg::BK;
        ii = e / Cfg::BK;
      } else {
        ii = e % Cfg::BM;
        kk = e / Cfg::BM;
      }
      const int gi = i0 + ii, gk = k0 + kk;
      sA[kk * Cfg::LDA + ii] = (gi < M && gk < K) ? loadA(gi, gk) : Acc(0);
    }
    for (int e = tid; e < Cfg::BK * Cfg::BN; e += Cfg::THREADS) {
      const int jj = e % Cfg::BN, kk = e / Cfg::BN;
      const int gj = j0 + jj, gk = k0 + kk;
      sB[kk * Cfg::BN + jj] = (gj < N && gk < K) ? loadB(gk, gj) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < Cfg::BK; ++kk) {
      Acc a[Cfg::TM], b[Cfg::TN];
#pragma unroll
      for (int m = 0; m < Cfg::TM; ++m) a[m] = sA[kk * Cfg::LDA + ty * Cfg::TM + m];
#pragma unroll
      for (int n = 0; n < Cfg::TN; ++n) b[n] = sB[kk * Cfg::BN + tx * Cfg::TN + n];
#pragma unroll
      for (int m = 0; m < Cfg::TM; ++m)
#pragma unroll
        for (int n = 0; n < Cfg::TN; ++n) acc[m][n] = fma_acc(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }
}

template <class Cfg, typename Acc>
__device__ __forceinline__ void zero_acc(Acc (&acc)[Cfg::TM][Cfg::TN]) {
#pragma unroll
  for (int m = 0; m < Cfg::TM; ++m)
#pragma unroll
    for (int n = 0; n < Cfg::TN; ++n) acc[m][n] = Acc(0);
}

// Calls store(i, j, value) for each in-range output the thread owns.
template <class Cfg, typename Acc, class Store>
__device__ __forceinline__ void store_tile(const Acc (&acc)[Cfg::TM][Cfg::TN], int i0, int j0,
                                          int M, int N, Store store) {
  const int tid = threadIdx.x;
  const int tx = tid % Cfg::TX;
  const int ty = tid / Cfg::TX;
#pragma unroll
  for (int m = 0; m < Cfg::TM; ++m) {
    const int gi = i0 + ty * Cfg::TM + m;
#pragma unroll
    for (int n = 0; n < Cfg::TN; ++n) {
      const int gj = j0 + tx * Cfg::TN + n;
      if (gi < M && gj < N) store(gi, gj, acc[m][n]);
    }
  }
}

// Sum over the 32 lanes of a warp; every lane gets the result.
template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <class Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
