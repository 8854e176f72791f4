// Batched economy QR by two-sweep modified Gram-Schmidt (MGS2):
//   Y (T, b, r) -> Q (T, b, r), R = Q^T Y (T, r, r), r <= b.
//
// Replaces the Pallas TPU kernel `batched_qr_pallas` / `_mgs_qr_kernel` /
// `_mgs_body` (src/repro/kernels/batched_qr.py). Same arithmetic: each sweep
// takes its drop tolerance max(rel * max column norm, tiny) from the current
// column norms (rel 1e-8 in f64, 1e-4 in f32); column k is normalised, or
// zeroed when its residual norm is not above the tolerance, and then
// projected out of every later column. R is formed in the kernel from the
// final Q and the original Y, as the Pallas kernel forms it.
//
// Bound on the H100: MGS2 with R = Q^T Y does about 6 b r^2 FLOPs a tile on
// 2 b r + r^2 words in and out (b = 512, r = 128: 50 MFLOP on 1.2 MB in f64,
// about 44 FLOP a byte; b = r = 128: 32 FLOP a byte), above the FP64 ridge of
// 20, so the FP64 rate bounds it, not HBM. What holds a simple kernel far
// below that rate is the dependency chain: r column steps one after another,
// each with a reduction across the block.
//
// Design: one block of 256 threads per tile. The working panel is kept
// transposed (column j contiguous), in shared memory when it fits (b = r =
// 128 in f64 is 128 KB), else in a device-memory scratch that the wrapper
// allocates at the size repro_batched_qr_scratch_* returns (b = 512, r = 128 in f64 is 512 KB, more than the 227 KB a block
// may use), where L2 serves it. Columns go in panels of NB = 16: the panel is
// factored in shared memory column by column, then each warp takes a trailing
// column into registers, applies the panel's 16 projections in order and
// writes the column back once. A trailing column makes one round trip to
// memory per panel instead of one per column, and every column still sees
// exactly MGS's sequence of operations. R = Q^T Y runs through the
// shared-memory FMA tile of common.cuh. Plain FMA loops, no DMMA yet.
#include <cfloat>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NB = 16;                         // columns per panel
constexpr int MAXV = 32;                       // register column: b <= 32 * MAXV
constexpr size_t SMEM_BUDGET = 200 * 1024;
using RCfg = Wide;                             // R = Q^T Y tiles, 256 threads

template <typename T> struct Cut;
template <> struct Cut<double> {
  static __device__ __forceinline__ double rel() { return 1e-8; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};
template <> struct Cut<float> {
  static __device__ __forceinline__ float rel() { return 1e-4f; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    mgs_qr_kernel(const T* __restrict__ Y, T* __restrict__ Q, T* __restrict__ R,
                  T* __restrict__ work, int b, int r, int sweeps, int w_in_smem) {
  static_assert(RCfg::THREADS == THREADS, "R tile config must use the block");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T sA[RCfg::SMEM_A];
  __shared__ T sB[RCfg::SMEM_B];
  __shared__ T s_red[WARPS];
  __shared__ T s_val;

  const long long t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nv = (b + 31) / 32;
  const T* Yt = Y + t * b * static_cast<long long>(r);
  T* P = reinterpret_cast<T*>(smem_raw);                       // NB x b panel
  T* W = w_in_smem ? P + NB * b : work + t * r * static_cast<long long>(b);

  // W[j * b + i] = Y[i, j]: the working panel, transposed.
  for (int e = tid; e < b * r; e += THREADS) W[(e % r) * b + e / r] = Yt[e];
  __syncthreads();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    // Drop tolerance from the current column norms.
    T mx = T(0);
    for (int j = warp; j < r; j += WARPS) {
      T ss = T(0);
      for (int i = lane; i < b; i += 32) ss = fma_acc(W[j * b + i], W[j * b + i], ss);
      mx = fmax(mx, sqrt(warp_sum(ss)));
    }
    if (lane == 0) s_red[warp] = mx;
    __syncthreads();
    if (tid == 0) {
      T m = T(0);
      for (int w = 0; w < WARPS; ++w) m = fmax(m, s_red[w]);
      s_val = fmax(Cut<T>::rel() * m, Cut<T>::tiny());
    }
    __syncthreads();
    const T tol = s_val;
    __syncthreads();

    for (int k0 = 0; k0 < r; k0 += NB) {
      const int kb = min(NB, r - k0);
      for (int e = tid; e < kb * b; e += THREADS) P[e] = W[k0 * b + e];
      __syncthreads();
      // Factor the panel: column by column, MGS inside shared memory.
      for (int kk = 0; kk < kb; ++kk) {
        T* pk = P + kk * b;
        if (warp == 0) {
          T ss = T(0);
          for (int i = lane; i < b; i += 32) ss = fma_acc(pk[i], pk[i], ss);
          ss = warp_sum(ss);
          if (lane == 0) s_val = sqrt(ss);
        }
        __syncthreads();
        const T nrm = s_val;
        const bool keep = nrm > tol;
        const T den = fmax(nrm, tol);
        for (int i = tid; i < b; i += THREADS) pk[i] = keep ? pk[i] / den : T(0);
        __syncthreads();
        for (int j = kk + 1 + warp; j < kb; j += WARPS) {
          T* pj = P + j * b;
          T d = T(0);
          for (int i = lane; i < b; i += 32) d = fma_acc(pk[i], pj[i], d);
          d = warp_sum(d);
          for (int i = lane; i < b; i += 32) pj[i] -= d * pk[i];
        }
        __syncthreads();
      }
      for (int e = tid; e < kb * b; e += THREADS) W[k0 * b + e] = P[e];
      // Trailing columns: one register round trip per panel.
      for (int j = k0 + kb + warp; j < r; j += WARPS) {
        T* wj = W + j * static_cast<long long>(b);
        T q[MAXV];
#pragma unroll
        for (int v = 0; v < MAXV; ++v) {
          const int i = lane + 32 * v;
          q[v] = (v < nv && i < b) ? wj[i] : T(0);
        }
        for (int kk = 0; kk < kb; ++kk) {
          const T* pk = P + kk * b;
          T d = T(0);
#pragma unroll
          for (int v = 0; v < MAXV; ++v) {
            const int i = lane + 32 * v;
            if (v < nv && i < b) d = fma_acc(pk[i], q[v], d);
          }
          d = warp_sum(d);
#pragma unroll
          for (int v = 0; v < MAXV; ++v) {
            const int i = lane + 32 * v;
            if (v < nv && i < b) q[v] -= d * pk[i];
          }
        }
#pragma unroll
        for (int v = 0; v < MAXV; ++v) {
          const int i = lane + 32 * v;
          if (v < nv && i < b) wj[i] = q[v];
        }
      }
      __syncthreads();
    }
  }

  // Q[i, j] = W[j * b + i]
  T* Qt = Q + t * b * static_cast<long long>(r);
  for (int e = tid; e < b * r; e += THREADS) Qt[e] = W[(e % r) * b + e / r];
  // R = Q^T Y: R[a, c] = sum_i W[a * b + i] Y[i, c]
  T* Rt = R + t * r * static_cast<long long>(r);
  for (int a0 = 0; a0 < r; a0 += RCfg::BM) {
    for (int c0 = 0; c0 < r; c0 += RCfg::BN) {
      T acc[RCfg::TM][RCfg::TN];
      zero_acc<RCfg>(acc);
      tile_mma<RCfg, true>(
          acc, a0, c0, r, r, b, [&](int a, int i) { return W[a * b + i]; },
          [&](int i, int c) { return Yt[static_cast<long long>(i) * r + c]; }, sA, sB);
      store_tile<RCfg>(acc, a0, c0, r, r, [&](int a, int c, T v) { Rt[a * r + c] = v; });
    }
  }
}

// Words of device scratch a tile needs: 0 when the working panel and one
// column panel fit in shared memory, else the r * b words of the panel. The
// one place that decides where the panel lives; the wrapper asks it.
template <typename T>
static long long scratch_words(int b, int r) {
  const bool w_in_smem = static_cast<size_t>(NB + r) * b * sizeof(T) <= SMEM_BUDGET;
  return w_in_smem ? 0 : static_cast<long long>(r) * b;
}

template <typename T>
static int dispatch(const void* Y, void* Q, void* R, void* work, int T_, int b, int r,
                    int sweeps, void* stream) {
  if (T_ == 0 || b == 0 || r == 0) return 0;
  if (r > b || b > 32 * MAXV) return static_cast<int>(cudaErrorInvalidValue);
  const bool w_in_smem = scratch_words<T>(b, r) == 0;
  if (!w_in_smem && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(NB + (w_in_smem ? r : 0)) * b * sizeof(T);
  cudaError_t err = allow_dynamic_smem(mgs_qr_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mgs_qr_kernel<T><<<T_, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Y), static_cast<T*>(Q), static_cast<T*>(R), static_cast<T*>(work),
      b, r, sweeps, w_in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {
long long repro_batched_qr_scratch_f64(int b, int r) { return scratch_words<double>(b, r); }
long long repro_batched_qr_scratch_f32(int b, int r) { return scratch_words<float>(b, r); }
int repro_batched_qr_f64(const void* Y, void* Q, void* R, void* work, int T_, int b, int r,
                         int sweeps, void* stream) {
  return dispatch<double>(Y, Q, R, work, T_, b, r, sweeps, stream);
}
int repro_batched_qr_f32(const void* Y, void* Q, void* R, void* work, int T_, int b, int r,
                         int sweeps, void* stream) {
  return dispatch<float>(Y, Q, R, work, T_, b, r, sweeps, stream);
}
}
