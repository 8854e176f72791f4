// Rank-masked batched GEMM:  C[t] = A[t][:, :rank_t] @ B[t][:rank_t, :].
//
// Replaces the Pallas TPU kernel `batched_gemm_pallas` / `_bgemm_kernel`
// (src/repro/kernels/batched_gemm.py). The TPU kernel multiplies the whole
// r_max-deep panel against an iota mask; here each block stops its K loop at
// min(rank_t, k), so the zero padding past a tile's rank costs no FLOPs and
// no bytes: the variable-rank batch the paper got from MAGMA.
//
// Bound on the H100: at the main path's shapes (m = 512, k = r_max = 128,
// n = bs = 16 or r_max) one tile does 2*m*n*rank FLOPs on m*rank + rank*n
// inputs, about n/4 FLOP per f64 byte: memory-bound for n = 16, and near the
// FP64 ridge for n = 128. The design reads each A element once per n-tile
// (one n-tile when n <= 16) and stops at the rank. Plain FMA loops, no
// DMMA or TMA yet.
//
// Grid: (T, ceil(m / BM), ceil(n / BN)), one (BM x BN) output tile a block.
#include "common.cuh"

using namespace repro;

template <typename T, class Cfg>
__global__ void __launch_bounds__(Cfg::THREADS)
    bgemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 const int* __restrict__ ranks, T* __restrict__ C, int m, int k, int n) {
  using Acc = typename AccOf<T>::type;
  __shared__ Acc sA[Cfg::SMEM_A];
  __shared__ Acc sB[Cfg::SMEM_B];
  const long long t = blockIdx.x;
  const int i0 = blockIdx.y * Cfg::BM;
  const int j0 = blockIdx.z * Cfg::BN;
  const int K = min(max(ranks[t], 0), k);
  const T* At = A + t * m * static_cast<long long>(k);
  const T* Bt = B + t * k * static_cast<long long>(n);
  T* Ct = C + t * m * static_cast<long long>(n);

  Acc acc[Cfg::TM][Cfg::TN];
  zero_acc<Cfg>(acc);
  tile_mma<Cfg, true>(
      acc, i0, j0, m, n, K,
      [&](int i, int kk) { return to_acc(At[static_cast<long long>(i) * k + kk]); },
      [&](int kk, int j) { return to_acc(Bt[static_cast<long long>(kk) * n + j]); }, sA, sB);
  store_tile<Cfg>(acc, i0, j0, m, n, [&](int i, int j, Acc v) {
    Ct[static_cast<long long>(i) * n + j] = from_acc<T>(v);
  });
}

template <typename T, class Cfg>
static int launch(const void* A, const void* B, const void* ranks, void* C, int T_, int m,
                  int k, int n, void* stream) {
  dim3 grid(T_, (m + Cfg::BM - 1) / Cfg::BM, (n + Cfg::BN - 1) / Cfg::BN);
  bgemm_kernel<T, Cfg><<<grid, Cfg::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<const int*>(ranks),
      static_cast<T*>(C), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* A, const void* B, const void* ranks, void* C, int T_, int m,
                    int k, int n, void* stream) {
  if (T_ == 0 || m == 0 || n == 0) return 0;
  if (n <= Narrow::BN) return launch<T, Narrow>(A, B, ranks, C, T_, m, k, n, stream);
  return launch<T, Wide>(A, B, ranks, C, T_, m, k, n, stream);
}

extern "C" {
int repro_batched_gemm_f64(const void* A, const void* B, const void* ranks, void* C, int T_,
                           int m, int k, int n, void* stream) {
  return dispatch<double>(A, B, ranks, C, T_, m, k, n, stream);
}
int repro_batched_gemm_f32(const void* A, const void* B, const void* ranks, void* C, int T_,
                           int m, int k, int n, void* stream) {
  return dispatch<float>(A, B, ranks, C, T_, m, k, n, stream);
}
int repro_batched_gemm_bf16(const void* A, const void* B, const void* ranks, void* C, int T_,
                            int m, int k, int n, void* stream) {
  return dispatch<__nv_bfloat16>(A, B, ranks, C, T_, m, k, n, stream);
}
}
