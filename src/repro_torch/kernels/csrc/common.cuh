// Shared pieces of the hand-written Hopper kernels (sm_90a).
//
// Every kernel of this directory is a short chain of small batched GEMMs.
// They share one block-level building block: `tile_mma` accumulates one
// (BM x BN) output tile of C = A B into per-thread registers, staging
// (BM x BK) and (BK x BN) slices of the operands through shared memory and
// running plain FMA loops on them. Operands are read through small device
// lambdas, so one routine serves row-major, transposed and shared-memory
// operands alike, and every load is bounds-checked (ragged b, r and s need
// no padding on the host). The f64 tensor-core instruction and `cp.async`
// copies are wrapped below for kernels that stage their own operands, and
// the thread block cluster pieces (distributed shared memory, mbarriers)
// that tile_chain's clusters pass partial sums with.
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

// FP64 tensor-core product (DMMA, sm_90): one warp computes
// d[16x8] += A[16x8] B[8x8]. Fragments (PTX ISA, mma.m16n8k8 .f64, as in
// CUTLASS's SM90_16x8x8_F64F64F64F64_TN), with lane = 4 g + q:
//   a = {A[g][q], A[g + 8][q], A[g][q + 4], A[g + 8][q + 4]},
//   b = {B[q][g], B[q + 4][g]},
//   d = {D[g][2q], D[g][2q + 1], D[g + 8][2q], D[g + 8][2q + 1]}.
// On the H100 this shape (like m16n8k4 and m16n8k16) runs at the FP64
// tensor-core peak; m8n8k4 runs at half of it (tools/dmma_rate.cu).
__device__ __forceinline__ void mma_m16n8k8_f64(double (&d)[4], const double (&a)[4],
                                                const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Asynchronous copy of BYTES (8 or 16) from device to shared memory
// (sm_80+): the first `src_bytes` come from src, the rest are zero-filled
// (src is not read when src_bytes is 0).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Thread block clusters (sm_90): the block's rank in its cluster, a barrier
// of all the cluster's threads (release / acquire), and the generic address
// of `p`'s counterpart in the shared memory of block `rank`.
__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, int rank) {
  unsigned long long mapped;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(mapped)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<T*>(mapped);
}

// mbarriers in shared memory (sm_90): a phase completes when the count given
// at init has arrived; waiters name the phase by its parity.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Makes the inits before it visible to the cluster's other blocks.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival, with cluster-scope release, on the counterpart of `bar` in
// block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(unsigned long long* bar, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
// Waits, with cluster-scope acquire, until the phase of parity `parity` has
// completed. Traps after about ten seconds (2^34 cycles) rather than hang
// on an arrival that never comes.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  long long t0 = -1;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 < 0)
      t0 = now;
    else if (now - t0 > (1LL << 34))
      __trap();
  }
}

// Shared memory above the 48 KB default needs an opt-in per kernel. The
// default covers a block's static and dynamic shared memory together, so a
// kernel with static arrays needs the opt-in below 48 KB of dynamic memory
// too (lr_sample's f64 FMA kernel: 18 KB static, and at r = 256 32 KB
// dynamic, failed to launch without it).
template <class Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (bytes + attr.sharedSizeBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
