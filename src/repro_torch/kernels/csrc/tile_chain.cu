// Batched two-product tile chain:  out[t] = U[t][:, :r] @ (V[t][:, :r]^T @ X[t]).
//
// Replaces the Pallas TPU kernel `tile_chain_pallas` / `_tile_chain_kernel`
// (src/repro/kernels/tlr_matvec.py). The TPU kernel keeps the whole (r x s)
// intermediate in VMEM. A whole panel does not fit a Hopper block's 227 KB of
// shared memory (r = s = 128 in f64 is 128 KB, r = b = 512 is 2 MB), so each
// block owns one chunk of SC = BN columns of X: it first forms
// W = V[t]^T X[t][:, chunk] (r x SC) in shared memory, then writes
// U[t] @ W. The intermediate never touches device memory.
//
// Bound on the H100: 4*b*r*s FLOPs on (2*b*r + 2*b*s) elements per tile.
// For s = bs = 16 that is ~s/2 FLOP per f64 byte (memory-bound); for
// s = r_max = 128 (the projection chains of sample_t) it is compute-bound
// on FP64. Each column chunk re-reads U[t] and V[t]: the wide (SC = 64)
// tile halves those re-reads for s = 128. Plain FMA loops, no DMMA or TMA
// yet.
//
// `ldr` is the row stride of U and V: a `width=` slice (r < ldr) of the
// zero-padded factors costs nothing on the host.
//
// Grid: (T, ceil(s / SC)); dynamic shared memory r * SC accumulator words.
#include "common.cuh"

using namespace repro;

template <typename T, class Cfg>
__global__ void __launch_bounds__(Cfg::THREADS)
    tile_chain_kernel(const T* __restrict__ U, const T* __restrict__ V,
                      const T* __restrict__ X, T* __restrict__ out, int b, int r, int ldr,
                      int s) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* W = reinterpret_cast<Acc*>(smem_raw);  // (r, SC) row-major
  __shared__ Acc sA[Cfg::SMEM_A];
  __shared__ Acc sB[Cfg::SMEM_B];
  constexpr int SC = Cfg::BN;
  const long long t = blockIdx.x;
  const int c0 = blockIdx.y * SC;
  const int nc = min(SC, s - c0);
  const T* Ut = U + t * b * static_cast<long long>(ldr);
  const T* Vt = V + t * b * static_cast<long long>(ldr);
  const T* Xt = X + t * b * static_cast<long long>(s);
  T* Ot = out + t * b * static_cast<long long>(s);

  Acc acc[Cfg::TM][Cfg::TN];
  // Phase 1: W = V^T X[:, chunk], contraction over the b rows.
  for (int i0 = 0; i0 < r; i0 += Cfg::BM) {
    zero_acc<Cfg>(acc);
    tile_mma<Cfg, false>(
        acc, i0, 0, r, nc, b,
        [&](int i, int kk) { return to_acc(Vt[static_cast<long long>(kk) * ldr + i]); },
        [&](int kk, int j) { return to_acc(Xt[static_cast<long long>(kk) * s + c0 + j]); },
        sA, sB);
    store_tile<Cfg>(acc, i0, 0, r, SC, [&](int i, int j, Acc v) { W[i * SC + j] = v; });
  }
  __syncthreads();
  // Phase 2: out[:, chunk] = U W, contraction over the r columns.
  for (int i0 = 0; i0 < b; i0 += Cfg::BM) {
    zero_acc<Cfg>(acc);
    tile_mma<Cfg, true>(
        acc, i0, 0, b, nc, r,
        [&](int i, int kk) { return to_acc(Ut[static_cast<long long>(i) * ldr + kk]); },
        [&](int kk, int j) { return W[kk * SC + j]; }, sA, sB);
    store_tile<Cfg>(acc, i0, 0, b, nc, [&](int i, int j, Acc v) {
      Ot[static_cast<long long>(i) * s + c0 + j] = from_acc<T>(v);
    });
  }
}

template <typename T, class Cfg>
static int launch(const void* U, const void* V, const void* X, void* out, int T_, int b, int r,
                  int ldr, int s, void* stream) {
  using Acc = typename AccOf<T>::type;
  const size_t smem = static_cast<size_t>(r) * Cfg::BN * sizeof(Acc);
  auto kernel = tile_chain_kernel<T, Cfg>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(T_, (s + Cfg::BN - 1) / Cfg::BN);
  kernel<<<grid, Cfg::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(U), static_cast<const T*>(V), static_cast<const T*>(X),
      static_cast<T*>(out), b, r, ldr, s);
  return static_cast<int>(cudaGetLastError());
}

// wide != 0 selects the 64-column chunk (the wrapper checks that r * 64
// accumulator words fit in shared memory).
template <typename T>
static int dispatch(const void* U, const void* V, const void* X, void* out, int T_, int b,
                    int r, int ldr, int s, int wide, void* stream) {
  if (T_ == 0 || b == 0 || s == 0) return 0;
  if (wide) return launch<T, Wide>(U, V, X, out, T_, b, r, ldr, s, stream);
  return launch<T, Narrow>(U, V, X, out, T_, b, r, ldr, s, stream);
}

extern "C" {
int repro_tile_chain_f64(const void* U, const void* V, const void* X, void* out, int T_, int b,
                         int r, int ldr, int s, int wide, void* stream) {
  return dispatch<double>(U, V, X, out, T_, b, r, ldr, s, wide, stream);
}
int repro_tile_chain_f32(const void* U, const void* V, const void* X, void* out, int T_, int b,
                         int r, int ldr, int s, int wide, void* stream) {
  return dispatch<float>(U, V, X, out, T_, b, r, ldr, s, wide, stream);
}
int repro_tile_chain_bf16(const void* U, const void* V, const void* X, void* out, int T_, int b,
                          int r, int ldr, int s, int wide, void* stream) {
  return dispatch<__nv_bfloat16>(U, V, X, out, T_, b, r, ldr, s, wide, stream);
}
}
