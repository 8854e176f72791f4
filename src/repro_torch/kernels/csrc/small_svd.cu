// Batched SVD of small cores by one-sided Jacobi rotations:
//   M (T, m, n), n <= m  ->  U (T, m, n), s (T, n), V (T, n, n),
//   M[t] = U diag(s) V^T, values unsorted (the dispatcher sorts them).
//
// Replaces the Pallas TPU kernel `small_svd_pallas` / `_jacobi_svd_kernel`
// (src/repro/kernels/small_svd.py). Same arithmetic per rotation: alpha,
// beta, gamma are the two columns' squared norms and inner product, theta =
// atan2(2 gamma, alpha - beta) / 2, the rotation is skipped when |gamma| <=
// tiny, and it is applied to the working matrix and to the accumulated V.
// After `sweeps` sweeps (8) the column norms are s, U is the normalised
// columns (zeroed where s <= tiny), and V is returned, not V^H.
//
// The rotations are the TPU kernel's, in its row-cyclic order, regrouped
// into wavefront stages: stage t = 1 .. 3n - 5 holds the pairs with
// 2p + q = t. The pairs of a stage share no column, and every pair sharing a
// column with (p, q) that comes before it in row-cyclic order sits in an
// earlier stage, so the stages in order do exactly the row-cyclic rotations
// (only the dot products' summation order differs) while a stage's up to
// n / 3 rotations run at once, one warp per pair. (A round-robin tournament,
// n / 2 pairs per round, needed about 16 sweeps to converge on the graded R
// factors of the rounding pass, where row-cyclic needs 8.) The plain version
// in small_svd.py runs the same stages.
//
// Bound on the H100: 8 sweeps of n(n-1)/2 rotations at 12 m + 6 n FLOPs each
// (three dot products and the rotation of two columns of A and of V):
// m = n = 128 is 150 MFLOP a tile on 3 x 128 KB in f64, about 380 FLOP a
// byte, so the FP64 rate bounds it. A simple kernel is held back instead by
// latency: 8 (3n - 5) stages, each ending in a block barrier, and a warp's
// share of a stage is one or two short dot products, a shuffle reduction
// and atan2 / sincos.
//
// Design: one block of 512 threads (16 warps) per tile, each warp taking the
// stage's pairs in turn. The working matrix is kept transposed (column j
// contiguous, so a warp's loads are coalesced) in shared memory when it fits
// (m = n = 128 in f64 is 128 KB); A and V together (256 KB) would not, so V
// accumulates in the V output itself, transposed, in device memory that L2
// serves, and is transposed in place at the end. A working matrix too large
// for shared memory (the densify branch at b = 512) lives in a device-memory
// scratch that the wrapper allocates at the size repro_small_svd_scratch_*
// returns.
#include <cfloat>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr size_t SMEM_BUDGET = 200 * 1024;

__device__ __forceinline__ double tiny_of(double) { return DBL_MIN; }
__device__ __forceinline__ float tiny_of(float) { return FLT_MIN; }
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) { sincosf(x, s, c); }

template <typename T>
__device__ __forceinline__ void rotate(T* __restrict__ x, T* __restrict__ y, int len, T c, T s,
                                       int lane) {
  for (int i = lane; i < len; i += 32) {
    const T a = x[i], b = y[i];
    x[i] = c * a + s * b;
    y[i] = -s * a + c * b;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    jacobi_svd_kernel(const T* __restrict__ M, T* __restrict__ U, T* __restrict__ S,
                      T* __restrict__ V, T* __restrict__ work, int m, int n, int sweeps,
                      int a_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T tiny = tiny_of(T(0));
  const T* Mt = M + t * m * static_cast<long long>(n);
  T* A = a_in_smem ? reinterpret_cast<T*>(smem_raw) : work + t * n * static_cast<long long>(m);
  T* Vt = V + t * n * static_cast<long long>(n);  // Vt[j * n + i] = V[i, j] until the end
  T* St = S + t * n;

  // A[j * m + i] = M[i, j];  Vt = I.
  for (int e = tid; e < m * n; e += THREADS) A[(e % n) * m + e / n] = Mt[e];
  for (int e = tid; e < n * n; e += THREADS) Vt[e] = (e / n == e % n) ? T(1) : T(0);
  __syncthreads();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int stage = 1; stage <= 3 * n - 5; ++stage) {
      // pairs (p, stage - 2p) with p < q < n
      const int lo = max(0, (stage - n + 2) / 2), hi = (stage - 1) / 3;
      for (int p = lo + warp; p <= hi; p += WARPS) {
        const int q = stage - 2 * p;
        T* ap = A + p * static_cast<long long>(m);
        T* aq = A + q * static_cast<long long>(m);
        T alpha = T(0), beta = T(0), gamma = T(0);
        for (int i = lane; i < m; i += 32) {
          const T x = ap[i], y = aq[i];
          alpha = fma_acc(x, x, alpha);
          beta = fma_acc(y, y, beta);
          gamma = fma_acc(x, y, gamma);
        }
        alpha = warp_sum(alpha);
        beta = warp_sum(beta);
        gamma = warp_sum(gamma);
        if (!(fabs(gamma) > tiny)) continue;  // warp-uniform: every lane holds the sums
        const T theta = T(0.5) * atan2(T(2) * gamma, alpha - beta);
        T sn, cs;
        sin_cos(theta, &sn, &cs);
        rotate(ap, aq, m, cs, sn, lane);
        rotate(Vt + p * n, Vt + q * n, n, cs, sn, lane);
      }
      __syncthreads();
    }
  }

  // s = column norms; U = normalised columns, zeroed where s <= tiny.
  for (int j = warp; j < n; j += WARPS) {
    T ss = T(0);
    for (int i = lane; i < m; i += 32) ss = fma_acc(A[j * m + i], A[j * m + i], ss);
    ss = warp_sum(ss);
    if (lane == 0) St[j] = sqrt(ss);
  }
  __syncthreads();
  T* Ut = U + t * m * static_cast<long long>(n);
  for (int e = tid; e < m * n; e += THREADS) {
    const int i = e / n, j = e % n;
    const T sj = St[j];
    Ut[e] = sj > tiny ? A[j * m + i] / fmax(sj, tiny) : T(0);
  }
  // V[i, j] = Vt[j * n + i]: transpose in place, one swap per pair i < j.
  for (int e = tid; e < n * n; e += THREADS) {
    const int i = e / n, j = e % n;
    if (i < j) {
      const T x = Vt[i * n + j];
      Vt[i * n + j] = Vt[j * n + i];
      Vt[j * n + i] = x;
    }
  }
}

// Words of device scratch a tile needs: 0 when the working matrix fits in
// shared memory, else its m * n words. The one place that decides where the
// working matrix lives; the wrapper asks it.
template <typename T>
static long long scratch_words(int m, int n) {
  const bool a_in_smem = static_cast<size_t>(m) * n * sizeof(T) <= SMEM_BUDGET;
  return a_in_smem ? 0 : static_cast<long long>(m) * n;
}

template <typename T>
static int dispatch(const void* M, void* U, void* S, void* V, void* work, int T_, int m, int n,
                    int sweeps, void* stream) {
  if (T_ == 0 || n == 0) return 0;
  if (n > m) return static_cast<int>(cudaErrorInvalidValue);
  const size_t a_bytes = static_cast<size_t>(m) * n * sizeof(T);
  const bool a_in_smem = scratch_words<T>(m, n) == 0;
  if (!a_in_smem && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = a_in_smem ? a_bytes : 0;
  cudaError_t err = allow_dynamic_smem(jacobi_svd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  jacobi_svd_kernel<T><<<T_, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(M), static_cast<T*>(U), static_cast<T*>(S), static_cast<T*>(V),
      static_cast<T*>(work), m, n, sweeps, a_in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {
long long repro_small_svd_scratch_f64(int m, int n) { return scratch_words<double>(m, n); }
long long repro_small_svd_scratch_f32(int m, int n) { return scratch_words<float>(m, n); }
int repro_small_svd_f64(const void* M, void* U, void* S, void* V, void* work, int T_, int m,
                        int n, int sweeps, void* stream) {
  return dispatch<double>(M, U, S, V, work, T_, m, n, sweeps, stream);
}
int repro_small_svd_f32(const void* M, void* U, void* S, void* V, void* work, int T_, int m,
                        int n, int sweeps, void* stream) {
  return dispatch<float>(M, U, S, V, work, T_, m, n, sweeps, stream);
}
}
