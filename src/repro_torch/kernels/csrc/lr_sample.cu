// Fused low-rank update-chain sampling (the Eq. 2 hot spot):
//
//     Y[t] = sum_j U[t, j][:, :r] @ (V[t, j][:, :r]^T @ W2[j])
//
// Replaces the Pallas TPU kernel `lr_sample_pallas` / `_lr_sample_kernel`
// (src/repro/kernels/lr_sample.py). On the TPU the j-reduction is a
// sequential "revisiting" grid axis with a VMEM accumulator. Hopper blocks
// run in no order, so nothing may carry between blocks: here the j axis is a
// loop inside the block and the accumulator stays in registers for the whole
// loop. For each j the block forms W = V[t, j]^T W2[j][:, chunk] (r x SC) in
// shared memory and adds U[t, j][rows, :] @ W to its accumulator; neither
// the (r x s) intermediates nor partial sums touch device memory.
//
// Bound on the H100: 4*b*r*s FLOPs per (t, j) on 2*b*r factor elements, about
// s/4 FLOP per f64 byte at s = bs = 16: memory-bound on reading Ui and Vi.
// At the main path's widths (T ~ 32-63 row tiles, one 16-column chunk) one
// block per (t, chunk) would leave most of the 132 SMs idle, so the b rows
// are split across blocks too (BM = 128 rows a block). What that recomputes:
// every row block of a tile forms the same W = V[t, j]^T W2[j] over all b
// rows, so V[t, j] is read ceil(b / BM) times instead of once (from L2 in
// the best case) and the first product's FLOPs repeat as often. Plain FMA
// loops, no DMMA or TMA yet.
//
// `ldr` is the row stride of U and V (the `width=` slice is free).
// Grid: (T, ceil(s / SC), ceil(b / BM)); dynamic shared memory r * SC words.
#include "common.cuh"

using namespace repro;

template <typename T, class Cfg>
__global__ void __launch_bounds__(Cfg::THREADS)
    lr_sample_kernel(const T* __restrict__ Ui, const T* __restrict__ Vi,
                     const T* __restrict__ W2, T* __restrict__ Y, int k, int b, int r, int ldr,
                     int s) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* W = reinterpret_cast<Acc*>(smem_raw);  // (r, SC) row-major
  __shared__ Acc sA[Cfg::SMEM_A];
  __shared__ Acc sB[Cfg::SMEM_B];
  constexpr int SC = Cfg::BN;
  const long long t = blockIdx.x;
  const int c0 = blockIdx.y * SC;
  const int row0 = blockIdx.z * Cfg::BM;
  const int nc = min(SC, s - c0);
  const long long tile = static_cast<long long>(b) * ldr;

  Acc acc[Cfg::TM][Cfg::TN];
  Acc part[Cfg::TM][Cfg::TN];
  zero_acc<Cfg>(acc);
  for (int j = 0; j < k; ++j) {
    const T* U = Ui + (t * k + j) * tile;
    const T* V = Vi + (t * k + j) * tile;
    const T* Wj = W2 + static_cast<long long>(j) * b * s;
    // W = V^T W2[j][:, chunk], contraction over all b rows.
    for (int i0 = 0; i0 < r; i0 += Cfg::BM) {
      zero_acc<Cfg>(part);
      tile_mma<Cfg, false>(
          part, i0, 0, r, nc, b,
          [&](int i, int kk) { return to_acc(V[static_cast<long long>(kk) * ldr + i]); },
          [&](int kk, int jj) { return to_acc(Wj[static_cast<long long>(kk) * s + c0 + jj]); },
          sA, sB);
      store_tile<Cfg>(part, i0, 0, r, SC, [&](int i, int jj, Acc v) { W[i * SC + jj] = v; });
    }
    __syncthreads();
    // acc += U[rows, :r] W, contraction over the r columns.
    tile_mma<Cfg, true>(
        acc, row0, 0, b, nc, r,
        [&](int i, int kk) { return to_acc(U[static_cast<long long>(i) * ldr + kk]); },
        [&](int kk, int jj) { return W[kk * SC + jj]; }, sA, sB);
    __syncthreads();  // W is rewritten by the next j
  }
  T* Yt = Y + t * b * static_cast<long long>(s);
  store_tile<Cfg>(acc, row0, 0, b, nc, [&](int i, int jj, Acc v) {
    Yt[static_cast<long long>(i) * s + c0 + jj] = from_acc<T>(v);
  });
}

template <typename T>
static int dispatch(const void* Ui, const void* Vi, const void* W2, void* Y, int T_, int k,
                    int b, int r, int ldr, int s, void* stream) {
  using Cfg = Tall;
  using Acc = typename AccOf<T>::type;
  if (T_ == 0 || b == 0 || s == 0) return 0;
  const size_t smem = static_cast<size_t>(r) * Cfg::BN * sizeof(Acc);
  auto kernel = lr_sample_kernel<T, Cfg>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(T_, (s + Cfg::BN - 1) / Cfg::BN, (b + Cfg::BM - 1) / Cfg::BM);
  kernel<<<grid, Cfg::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Ui), static_cast<const T*>(Vi), static_cast<const T*>(W2),
      static_cast<T*>(Y), k, b, r, ldr, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {
int repro_lr_sample_f64(const void* Ui, const void* Vi, const void* W2, void* Y, int T_, int k,
                        int b, int r, int ldr, int s, void* stream) {
  return dispatch<double>(Ui, Vi, W2, Y, T_, k, b, r, ldr, s, stream);
}
int repro_lr_sample_f32(const void* Ui, const void* Vi, const void* W2, void* Y, int T_, int k,
                        int b, int r, int ldr, int s, void* stream) {
  return dispatch<float>(Ui, Vi, W2, Y, T_, k, b, r, ldr, s, stream);
}
int repro_lr_sample_bf16(const void* Ui, const void* Vi, const void* W2, void* Y, int T_, int k,
                         int b, int r, int ldr, int s, void* stream) {
  return dispatch<__nv_bfloat16>(Ui, Vi, W2, Y, T_, k, b, r, ldr, s, stream);
}
}
