// Batched economy QR by two-sweep modified Gram-Schmidt (MGS2):
//   Y (T, b, r) -> Q (T, b, r), R = Q^T Y (T, r, r), r <= b <= 1024.
//
// Replaces the Pallas TPU kernel `batched_qr_pallas` / `_mgs_qr_kernel` /
// `_mgs_body` (src/repro/kernels/batched_qr.py). Same arithmetic: each sweep
// takes its drop tolerance max(rel * max column norm, tiny) from the current
// column norms (rel 1e-8 in f64, 1e-4 in f32); column k is normalised, or
// zeroed when its residual norm is not above the tolerance, and then
// projected out of every later column. R is formed in the kernel from the
// final Q and the original Y, as the Pallas kernel forms it.
//
// Bound on the H100: MGS2 with R = Q^T Y does 6 b r^2 FLOPs a tile (two
// sweeps of 2 b r^2, and 2 b r^2 for R) on 2 b r + r^2 words in and out. At
// (2016, 128, 128) that is 2.54e10 FLOP, 0.3786 ms at the FP64 tensor-core
// peak (67 TFLOP/s), against 0.55 GB (0.16 ms); at op.round's (2016, 512,
// 128) 1.01e11 FLOP, 1.5145 ms, against 2.25 GB (0.67 ms). The operations
// bound it, if they run on the tensor cores.
//
// What held the first design (`mgs_qr_kernel` below) back: one
// 256-thread block a tile and 2 x r column steps in a chain, each with its
// norm in one warp and three block barriers; the trailing update projected
// the 16 columns of a panel out of each later column one at a time, a dot
// product, a 5-step warp reduction and an axpy per (column, projection),
// r^2 / 2 dependent reductions a sweep, on 32-step register loops guarded at
// run time where b = 128 needs 4; transposed staging that hit one bank with
// every lane; R = Q^T Y on the FMA pipes. On an NVIDIA H100 80GB HBM3 at
// 700 W: 24.97 ms at (2016, 128, 128), 66x its bound; 41.19 ms at (2016,
// 512, 128).
//
// The blocked identity. Let P = [p_1 .. p_NB] be a finished panel (a dead
// column is a zero column). MGS turns a later column w into w - P d with
//   d_a = p_a^T (w - sum_{c<a} p_c d_c) = p_a^T w - sum_{c<a} (p_a^T p_c) d_c,
// that is (I + L) d = P^T w, L the strictly lower part of G = P^T P (the
// inverse compact-WY form of MGS; Swirydowicz, Langou, Ananthan, Yang and
// Thomas, Numer. Linear Algebra Appl. 2021). It is MGS's own recurrence, so
// it keeps MGS's loss of orthogonality; only the order of the sums differs.
// A panel's trailing update is then S = P^T W_t and W_t -= P D, two matrix
// products for the tensor cores, with a 16-row forward substitution
// (I + L) D = S between them, one thread a column: no reduction across a
// warp per projection.
//
// The design (f64 on `mma.m16n8k8` DMMA; f32 the same structure, its
// products by FMA in the same fragment ownership, never TF32):
//  - Panels of NB = 16 columns, factored by one warpgroup (warps 0-3, one
//    per SM sub-partition), each thread holding its rows of the panel in
//    registers (a compile-time count: 1 at b <= 128, 4 at b <= 512). A
//    column step reduces |w_k|^2 and w_k^T w_j for the panel's 16 columns
//    in one reduce-scatter (15 shuffles and adds, where 16 butterflies take
//    80), adds the four warps' partials in a fixed order after one named
//    barrier (`bar.sync 1, 128`, the four-value exchange), broadcasts the
//    sums by shuffles, and takes 1 / |w_k| from one reciprocal square root
//    (d_j = w_k^T w_j / |w_k|): no block barrier. The loop body is one
//    step, the register panel rotating by a column after it, so the code
//    stays in the instruction cache (a fully unrolled panel measured
//    slower).
//  - `mgs_qr_smem`, b <= 128 (every shape of the right-looking driver at
//    tile 128): the whole working matrix in shared memory, row-major, rows
//    padded to 128 and columns to a multiple of 16 with zeros (zero rows and
//    columns change no norm, no dot product and no keep decision), loaded
//    with cp.async. Lookahead: once a panel is factored, warps 0-3 form G
//    and the next panel's S, D and update, then factor it, while warps 4-7
//    do the later columns' S, D and update on the tensor cores; named
//    barriers order the two teams, one block barrier a panel. Q is stored
//    from shared memory; R = Q^T Y reads Q there and Y once more from
//    device memory in 32-row slabs. 170 KB of shared memory in f64 (one
//    block an SM), 86 KB in f32.
//  - `mgs_qr_stream`, 128 < b <= 512 and r <= 128 (op.round's factor
//    stacks): the working matrix lives in Q itself (device memory, which L2
//    serves, 512 KB a tile at b = 512); the panel (512 x 16) sits in shared
//    memory; the trailing columns stream through shared memory in chunks
//    of 8 with double-buffered cp.async, each read and written once a
//    panel, S's 512-deep product split over the eight warps with the
//    partial sums added in a fixed order. R = Q^T Y stages both in 64-row
//    slabs. Its chunk traffic (about 9 MB a tile) bounds it.
//  - Row-major shared-memory panels with a leading dimension = 4 or 12
//    (mod 16) words: every DMMA operand fragment (P^T and the columns for S,
//    P and D for the update, Q^T and Y for R) is read without bank
//    conflicts, and Y is staged with 16-byte copies into the same layout.
//  - Everything else (b > 512, or b > 128 with r > 128) keeps the first
//    design, `mgs_qr_kernel`, with its device scratch.
// All sums run in a fixed order, so two calls agree bit for bit. On graded
// tiles Q differs from the plain column-by-column MGS2 far above rounding,
// as it does for any other summation order (the plain version with its
// rows permuted moves Q by 1e-8); the tests hold such inputs to the QR
// contract instead.
#include <cfloat>
#include <cstdint>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NB = 16;                         // columns per panel
constexpr int MAXV = 32;                       // first design: b <= 32 * MAXV
constexpr size_t SMEM_BUDGET = 200 * 1024;
using RCfg = Wide;                             // first design's R tiles

// Kernel configurations, chosen by `config` from the shapes alone.
constexpr int CFG_FIRST = 0;                   // mgs_qr_kernel
constexpr int CFG_SMEM = 1;                    // mgs_qr_smem
constexpr int CFG_STREAM = 2;                  // mgs_qr_stream

constexpr int RPT = 4;                         // panel rows a factoring thread holds
constexpr int SMALL_ROWS = 128;                // mgs_qr_smem's padded rows
constexpr int STREAM_ROWS = 512;               // mgs_qr_stream's padded rows
constexpr int CW = 8;                          // mgs_qr_stream's chunk width
constexpr int LDP = NB + 4;                    // its panel's leading dimension
constexpr int LDC = CW + 4;                    // its chunks' leading dimension
constexpr int MAX_R = 128;                     // r of the blocked kernels

template <typename T> struct Cut;
template <> struct Cut<double> {
  static __device__ __forceinline__ double rel() { return 1e-8; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};
template <> struct Cut<float> {
  static __device__ __forceinline__ float rel() { return 1e-4f; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// Leading dimension of a row-major shared-memory panel of n columns (n a
// multiple of 8): n + 4 = 4 or 12 (mod 16) words, so the DMMA fragments'
// reads, 4 rows x 4 columns in each half warp, hit 16 distinct word pairs.
__host__ __device__ constexpr int pad_ld(int n) { return n + 4; }

template <typename T> struct Vec2;
template <> struct Vec2<double> { using type = double2; };
template <> struct Vec2<float> { using type = float2; };

// Asynchronous copy of BYTES (4, 8 or 16) through L1 (cp.async.ca); the
// first src_bytes come from src, the rest are zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(BYTES), "r"(src_bytes));
}

// Named barriers (id 0 is __syncthreads): bar_sync waits for `threads`
// arrivals, bar_arrive counts the caller's warp without waiting.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// dst[i * ldd + j] = src[i * lds + j] for i < rows, j < cols, and zero for
// rows <= i < rows_pad or cols <= j < cols_pad (cols_pad even), by cp.async
// (the caller commits and waits). With `vec`, two words a copy (cols even,
// src and lds aligned to two words), else one.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* src, long long lds, int rows,
                                      int cols, int rows_pad, int cols_pad, bool vec) {
  if (vec) {
    const int w = cols_pad / 2;
    for (int e = threadIdx.x; e < rows_pad * w; e += THREADS) {
      const int i = e / w, j = 2 * (e - i * w);
      const bool in = i < rows && j < cols;
      cp_async_ca<2 * sizeof(T)>(dst + i * ldd + j, in ? src + i * lds + j : src,
                                 in ? 2 * sizeof(T) : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows_pad * cols_pad; e += THREADS) {
      const int i = e / cols_pad, j = e - i * cols_pad;
      const bool in = i < rows && j < cols;
      cp_async_ca<sizeof(T)>(dst + i * ldd + j, in ? src + i * lds + j : src,
                             in ? sizeof(T) : 0);
    }
  }
}

// dst[i * ldd + j] = src[i * lds + j] for i < rows, j < cols (device memory
// from shared memory).
template <typename T>
__device__ __forceinline__ void unstage(T* dst, long long ldd, const T* src, int lds, int rows,
                                        int cols, bool vec) {
  if (cols <= 0) return;
  if (vec) {
    using V2 = typename Vec2<T>::type;
    const int w = cols / 2;
    for (int e = threadIdx.x; e < rows * w; e += THREADS) {
      const int i = e / w, j = 2 * (e - i * w);
      *reinterpret_cast<V2*>(dst + i * ldd + j) =
          *reinterpret_cast<const V2*>(src + i * lds + j);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int i = e / cols, j = e - i * cols;
      dst[i * ldd + j] = src[i * lds + j];
    }
  }
}

// One warp: d (16 x 8) += A (16 x 8) B (8 x 8) with d in the DMMA fragment
// layout (common.cuh): lane 4 g + q owns D[g][2q], D[g][2q+1], D[g+8][2q],
// D[g+8][2q+1]. A(m, k) and B(k, n) read shared memory. f64 runs one
// mma.m16n8k8; f32 the same outputs by eight FMAs each, in order of k.
template <class LA, class LB>
__device__ __forceinline__ void tile_op(double (&d)[4], int g, int q, LA A, LB B) {
  const double a[4] = {A(g, q), A(g + 8, q), A(g, q + 4), A(g + 8, q + 4)};
  const double bb[2] = {B(q, g), B(q + 4, g)};
  mma_m16n8k8_f64(d, a, bb);
}
template <class LA, class LB>
__device__ __forceinline__ void tile_op(float (&d)[4], int g, int q, LA A, LB B) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float a0 = A(g, k), a1 = A(g + 8, k);
    const float b0 = B(k, 2 * q), b1 = B(k, 2 * q + 1);
    d[0] = __fmaf_rn(a0, b0, d[0]);
    d[1] = __fmaf_rn(a0, b1, d[1]);
    d[2] = __fmaf_rn(a1, b0, d[2]);
    d[3] = __fmaf_rn(a1, b1, d[3]);
  }
}

// Sp[(kp * NB + m) * lds + j] = sum over rows k of part kp of P[k][m] C[k][j]
// for m < NB, j < n (n a multiple of 8): G = P^T P or S = P^T W_t, the
// ROWS-deep sum split into ks parts (1, 2, 4 or 8; ROWS / ks a multiple of
// 16) so that every warp has work; the caller adds the parts in order.
// A team of nw warps shares the work; the caller is its warp ti.
template <typename T, int ROWS>
__device__ __forceinline__ void panel_dots(const T* P, int ldp, const T* C, int ldc, int n,
                                           int ks, T* Sp, int lds, int ti, int nw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int ntl = n / 8, krows = ROWS / ks;
  for (int it = ti; it < ntl * ks; it += nw) {
    const int j0 = (it % ntl) * 8, kp = it / ntl;
    // two accumulators (even and odd 8-row steps, krows a multiple of 16)
    // halve the chain of dependent products
    T d[4] = {T(0), T(0), T(0), T(0)}, e[4] = {T(0), T(0), T(0), T(0)};
    const T* Pk = P + kp * krows * ldp;
    const T* Ck = C + kp * krows * ldc + j0;
#pragma unroll 2
    for (int k0 = 0; k0 < krows; k0 += 16) {
      tile_op(d, g, q, [&](int m, int k) { return Pk[(k0 + k) * ldp + m]; },
              [&](int k, int c) { return Ck[(k0 + k) * ldc + c]; });
      tile_op(e, g, q, [&](int m, int k) { return Pk[(k0 + 8 + k) * ldp + m]; },
              [&](int k, int c) { return Ck[(k0 + 8 + k) * ldc + c]; });
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) d[x] += e[x];
    T* S = Sp + kp * NB * lds + j0;
    S[g * lds + 2 * q] = d[0];
    S[g * lds + 2 * q + 1] = d[1];
    S[(g + 8) * lds + 2 * q] = d[2];
    S[(g + 8) * lds + 2 * q + 1] = d[3];
  }
}

// The MGS projections of column j onto the panel: D[a][j] = s_a - sum_{c<a}
// G[a][c] D[c][j], s_a = sum_kp Sp[kp][a][j], one thread a column, j < n,
// by a team of nt threads in which the caller is thread tt.
template <typename T>
__device__ __forceinline__ void panel_solve(const T* Sp, int lds, int ks, const T* G, int ldg,
                                            T* D, int ldd, int n, int tt, int nt) {
  for (int j = tt; j < n; j += nt) {
    T d[NB];
#pragma unroll
    for (int a = 0; a < NB; ++a) {
      T s = Sp[a * lds + j];
      for (int kp = 1; kp < ks; ++kp) s += Sp[(kp * NB + a) * lds + j];
#pragma unroll
      for (int c = 0; c < a; ++c) s = fma_acc(-G[a * ldg + c], d[c], s);
      d[a] = s;
      D[a * ldd + j] = s;
    }
  }
}

// C[i][j] -= sum_m P[i][m] D[m][j] for i < ROWS, j < n (n a multiple of 8),
// by a team of nw warps in which the caller is warp ti.
template <typename T, int ROWS>
__device__ __forceinline__ void panel_update(const T* P, int ldp, const T* D, int ldd, T* C,
                                             int ldc, int n, int ti, int nw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int ntl = n / 8;
  for (int it = ti; it < (ROWS / 16) * ntl; it += nw) {
    const int i0 = (it / ntl) * 16, j0 = (it % ntl) * 8;
    T* Ct = C + i0 * ldc + j0;
    const T* Pi = P + i0 * ldp;
    const T* Dj = D + j0;
    T d[4] = {Ct[g * ldc + 2 * q], Ct[g * ldc + 2 * q + 1], Ct[(g + 8) * ldc + 2 * q],
              Ct[(g + 8) * ldc + 2 * q + 1]};
#pragma unroll
    for (int k0 = 0; k0 < NB; k0 += 8)
      tile_op(d, g, q, [&](int m, int k) { return Pi[m * ldp + k0 + k]; },
              [&](int k, int c) { return -Dj[(k0 + k) * ldd + c]; });
    Ct[g * ldc + 2 * q] = d[0];
    Ct[g * ldc + 2 * q + 1] = d[1];
    Ct[(g + 8) * ldc + 2 * q] = d[2];
    Ct[(g + 8) * ldc + 2 * q + 1] = d[3];
  }
}

// Sum of v[j] over the 32 lanes of a warp for the NB = 16 values at once,
// scattered: the result is value lane >> 1 (lanes 2j and 2j + 1 hold value
// j). Four halving steps (offsets 16, 8, 4, 2), each lane sending the half
// of its values that its partner keeps, then one plain step: 15 shuffles
// and adds where 16 butterflies take 80.
template <typename T>
__device__ __forceinline__ T reduce_scatter16(const T (&v)[NB], int lane) {
  static_assert(NB == 16, "four halving steps");
  T a[8], b[4], c[2];
  const bool u4 = lane & 16, u3 = lane & 8, u2 = lane & 4, u1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = (u4 ? v[i + 8] : v[i]) + __shfl_xor_sync(0xffffffffu, u4 ? v[i] : v[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (u3 ? a[i + 4] : a[i]) + __shfl_xor_sync(0xffffffffu, u3 ? a[i] : a[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (u2 ? b[i + 2] : b[i]) + __shfl_xor_sync(0xffffffffu, u2 ? b[i] : b[i + 2], 4);
  T d = (u1 ? c[1] : c[0]) + __shfl_xor_sync(0xffffffffu, u1 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(0xffffffffu, d, 1);
}

// MGS over the NB columns of the panel P (FW * 32 * RPT rows, row-major,
// leading dimension ldp) by warps 0 .. FW-1 (one per SM sub-partition),
// thread f holding rows f + FW * 32 * i in registers. Step k reduces
// |p_k|^2 and p_k^T p_j in one reduce-scatter; the FW warps' partials of
// each value are added in order through `red` (2 x FW x NB words, double
// buffered) under one named barrier, the four-value exchange; 16
// shuffles broadcast the sums. Then p_k = p_k / |p_k| or 0, and p_j -=
// (p_k^T p_j / |p_k|) p_k for the later columns. The loop body is one step:
// the register panel rotates left by one after it, so the current column
// always sits at index 0 and the code stays small in the instruction cache
// (a fully unrolled panel measured slower); after NB steps every column is
// back in place.
template <typename T, int FW, int RPT>
__device__ __forceinline__ void panel_factor(T* P, int ldp, T tol, T* red) {
  using V2 = typename Vec2<T>::type;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T p[RPT][NB];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const V2* row = reinterpret_cast<const V2*>(P + (tid + FW * 32 * i) * ldp);
#pragma unroll
    for (int c = 0; c < NB / 2; ++c) {
      const V2 v = row[c];
      p[i][2 * c] = v.x;
      p[i][2 * c + 1] = v.y;
    }
  }
#pragma unroll 1
  for (int k = 0; k < NB; ++k) {
    // p[.][0] is column k, p[.][1 .. NB-1-k] the later columns, the rest
    // finished ones rotated out.
    T v[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc = fma_acc(p[i][0], p[i][j], acc);
      v[j] = acc;
    }
    T x = reduce_scatter16(v, lane);
    if constexpr (FW > 1) {
      T* r = red + (k & 1) * FW * NB;
      if ((lane & 1) == 0) r[warp * NB + (lane >> 1)] = x;
      bar_sync(1, FW * 32);
      x = r[lane >> 1];
#pragma unroll
      for (int w = 1; w < FW; ++w) x += r[w * NB + (lane >> 1)];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) v[j] = __shfl_sync(0xffffffffu, x, 2 * j);
    // 1 / |p_k| by one reciprocal square root (within an ulp of 1 / sqrt,
    // on the chain's critical path in place of a root and a division); a
    // zero column gives nrm = 0 * inf = NaN, which is not kept. A kept
    // column has |p_k| > tol, so max(|p_k|, tol) = |p_k|.
    const T inv = rsqrt(v[0]);
    const T nrm = v[0] * inv;
    const bool keep = nrm > tol;
    T qk[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) qk[i] = keep ? p[i][0] * inv : T(0);
#pragma unroll
    for (int j = 1; j < NB; ++j) {
      const T d = (keep && j < NB - k) ? v[j] * inv : T(0);
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i][j - 1] = fma_acc(-d, qk[i], p[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) p[i][NB - 1] = qk[i];
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    V2* row = reinterpret_cast<V2*>(P + (tid + FW * 32 * i) * ldp);
#pragma unroll
    for (int c = 0; c < NB / 2; ++c) {
      V2 v;
      v.x = p[i][2 * c];
      v.y = p[i][2 * c + 1];
      row[c] = v;
    }
  }
}

// The sweep's drop tolerance, max(rel * max_j |X[:, j]|, tiny), over the
// rows x r block X (row-major, leading dimension ld; shared or device
// memory), r <= 128: two threads a column, their halves added in order.
// `red` holds 2 * 128 + WARPS words. Every thread gets the value.
template <typename T>
__device__ __forceinline__ T drop_tol(const T* X, long long ld, int rows, int r, T* red,
                                      T* s_tol) {
  const int tid = threadIdx.x, c = tid & 127, h = tid >> 7, lane = tid & 31, warp = tid >> 5;
  T ss = T(0);
  if (c < r) {
#pragma unroll 4
    for (int i = h; i < rows; i += 2) {
      const T x = X[i * ld + c];
      ss = fma_acc(x, x, ss);
    }
  }
  red[h * 128 + c] = ss;
  __syncthreads();
  T mx = tid < 128 ? sqrt(red[tid] + red[128 + tid]) : T(0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[256 + warp] = mx;
  __syncthreads();
  if (tid == 0) {
    T m = T(0);
    for (int w = 0; w < WARPS; ++w) m = fmax(m, red[256 + w]);
    *s_tol = fmax(Cut<T>::rel() * m, Cut<T>::tiny());
  }
  __syncthreads();
  return *s_tol;
}

// R = Q^T Y for one tile, r <= 128 (rp = r rounded up to 16): Y streams
// through `Ybuf` in KR-row slabs (KR x (rp + 4) words), and so does Q when
// it is not in shared memory (Qsm null: from Qg through `Qbuf`). Warp w
// accumulates the 16 x 8 output tiles w, w + 8, ... in registers.
template <int KR, typename T>
__device__ __forceinline__ void r_product(const T* Qsm, int ldq, const T* Qg, T* Qbuf,
                                          const T* Yg, T* Ybuf, int b, int r, T* Rt, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int rp = round_up(r, NB), ldb = pad_ld(rp);
  const int ntl = rp / 8, items = (rp / 16) * ntl;  // <= 128: 16 a warp
  T acc[16][4];
#pragma unroll
  for (int u = 0; u < 16; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = T(0);
  for (int k0 = 0; k0 < b; k0 += KR) {
    const int kr = min(KR, b - k0);
    stage(Ybuf, ldb, Yg + static_cast<long long>(k0) * r, r, kr, r, KR, rp, vec);
    if (Qsm == nullptr)
      stage(Qbuf, ldb, Qg + static_cast<long long>(k0) * r, r, kr, r, KR, rp, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const T* Qk = Qsm != nullptr ? Qsm + k0 * ldq : Qbuf;
    const int lq = Qsm != nullptr ? ldq : ldb;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int f = warp + WARPS * u;
      if (f < items) {
        const int m0 = (f / ntl) * 16, j0 = (f % ntl) * 8;
#pragma unroll
        for (int kk = 0; kk < KR; kk += 8)
          tile_op(acc[u], g, q, [&](int m, int k) { return Qk[(kk + k) * lq + m0 + m]; },
                  [&](int k, int c) { return Ybuf[(kk + k) * ldb + j0 + c]; });
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int f = warp + WARPS * u;
    if (f < items) {
      const int m0 = (f / ntl) * 16, j0 = (f % ntl) * 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + g + 8 * (e >> 1), j = j0 + 2 * q + (e & 1);
        if (i < r && j < r) Rt[i * r + j] = acc[u][e];
      }
    }
  }
}

// b <= 128: the working matrix in shared memory (see the header).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    mgs_qr_smem(const T* __restrict__ Y, T* __restrict__ Q, T* __restrict__ R, int b, int r,
                int sweeps, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[2 * 128 + WARPS];
  __shared__ T s_tol;
  const int warp = threadIdx.x >> 5;
  const int rp = round_up(r, NB), ldw = pad_ld(rp);
  T* W = reinterpret_cast<T*>(smem_raw);   // SMALL_ROWS x ldw
  T* S = W + SMALL_ROWS * ldw;             // NB x ldw: G = P^T P | S = P^T W_t
  T* D = S + NB * ldw;                     // NB x ldw: the projections
  const long long t = blockIdx.x;
  const T* Yt = Y + t * b * static_cast<long long>(r);
  T* Qt = Q + t * b * static_cast<long long>(r);

  stage(W, ldw, Yt, r, b, r, SMALL_ROWS, rp, vec != 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Warps 0-3 (one per SM sub-partition) factor the panels; with the
  // lookahead below they are team A, warps 4-7 team B.
  const int lane = threadIdx.x & 31;
  const bool in_a = warp < 4;
  const int ti = in_a ? warp : warp - 4;
  T* fred = D + NB * ldw;                  // 2 x 4 x NB: the factor's exchange
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    const T tol = drop_tol(W, ldw, b, r, red, &s_tol);
    if (in_a) panel_factor<T, 4, 1>(W, ldw, tol, fred);
    __syncthreads();
    for (int k0 = 0; k0 + NB < rp; k0 += NB) {
      // Panel k0 is factored. Lookahead: team A brings the next panel up to
      // date (G, its S and D, its update; named barrier 1) and factors it,
      // while team B does the columns after it (barrier 2), taking G from
      // team A through barrier 3.
      const T* P = W + k0;
      const int nt = rp - k0 - NB, nn = min(NB, nt), nr = nt - nn;
      if (in_a) {
        panel_dots<T, SMALL_ROWS>(P, ldw, P, ldw, NB + nn, 1, S, ldw, ti, 4);
        bar_arrive(3, THREADS);
        bar_sync(1, 128);
        panel_solve(S + NB, ldw, 1, S, ldw, D, ldw, nn, 32 * ti + lane, 128);
        bar_sync(1, 128);
        panel_update<T, SMALL_ROWS>(P, ldw, D, ldw, W + k0 + NB, ldw, nn, ti, 4);
        bar_sync(1, 128);
        panel_factor<T, 4, 1>(W + k0 + NB, ldw, tol, fred);
      } else {
        if (nr > 0)
          panel_dots<T, SMALL_ROWS>(P, ldw, W + k0 + NB + nn, ldw, nr, 1, S + NB + nn, ldw, ti,
                                    4);
        bar_sync(3, THREADS);
        if (nr > 0) {
          panel_solve(S + NB + nn, ldw, 1, S, ldw, D + nn, ldw, nr, 32 * ti + lane, 128);
          bar_sync(2, 128);
          panel_update<T, SMALL_ROWS>(P, ldw, D + nn, ldw, W + k0 + NB + nn, ldw, nr, ti, 4);
        }
      }
      __syncthreads();
    }
  }

  unstage(Qt, r, W, ldw, b, r, vec != 0);
  // R = Q^T Y: Q from W, Y in 32-row slabs through S | D (2 NB rows of ldw)
  r_product<2 * NB>(W, ldw, static_cast<const T*>(nullptr), static_cast<T*>(nullptr), Yt, S,
                    b, r, R + t * r * static_cast<long long>(r), vec != 0);
}

// 128 < b <= 512, r <= 128: the working matrix in Q, panels and chunks
// through shared memory (see the header).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    mgs_qr_stream(const T* __restrict__ Y, T* __restrict__ Q, T* __restrict__ R, int b, int r,
                  int sweeps, int vec) {
  constexpr int FW = STREAM_ROWS / (32 * RPT);  // 4 factoring warps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T nred[2 * 128 + WARPS];
  __shared__ T s_tol;
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool v2 = vec != 0;
  const int rp = round_up(r, NB);
  T* P = reinterpret_cast<T*>(smem_raw);      // STREAM_ROWS x LDP
  T* C0 = P + STREAM_ROWS * LDP;              // 2 x STREAM_ROWS x LDC
  T* Sp = C0 + 2 * STREAM_ROWS * LDC;         // 8 x NB x LDC partial sums
  T* G = Sp + 8 * NB * LDC;                   // NB x LDP
  T* D = G + NB * LDP;                        // NB x LDC
  T* red = D + NB * LDC;                      // 2 x FW x NB
  const long long t = blockIdx.x;
  const T* Yt = Y + t * b * static_cast<long long>(r);
  T* Qt = Q + t * b * static_cast<long long>(r);

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    const T tol = drop_tol(sweep == 0 ? Yt : Qt, r, b, r, nred, &s_tol);
    for (int k0 = 0; k0 < rp; k0 += NB) {
      // Until panel 0 of sweep 0 has written them, the columns are in Y.
      const T* X = (sweep == 0 && k0 == 0) ? Yt : Qt;
      const int nch = r - k0 - NB > 0 ? (r - k0 - NB + CW - 1) / CW : 0;
      stage(P, LDP, X + k0, r, b, min(NB, r - k0), STREAM_ROWS, NB, v2);
      cp_async_commit();
      if (nch > 0)
        stage(C0, LDC, X + k0 + NB, r, b, min(CW, r - k0 - NB), STREAM_ROWS, CW, v2);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (warp < FW) panel_factor<T, FW, RPT>(P, LDP, tol, red);
      __syncthreads();
      unstage(Qt + k0, r, P, LDP, b, min(NB, r - k0), v2);
      if (nch > 0) {
        panel_dots<T, STREAM_ROWS>(P, LDP, P, LDP, NB, 4, Sp, LDP, warp, WARPS);
        __syncthreads();
        for (int e = tid; e < NB * NB; e += THREADS) {
          const int a = e / NB, c = e % NB;
          T s = Sp[a * LDP + c];
#pragma unroll
          for (int kp = 1; kp < 4; ++kp) s += Sp[(kp * NB + a) * LDP + c];
          G[a * LDP + c] = s;
        }
        __syncthreads();
        for (int ch = 0; ch < nch; ++ch) {
          T* Cb = C0 + (ch & 1) * STREAM_ROWS * LDC;
          const int j0 = k0 + NB + ch * CW;
          if (ch + 1 < nch)
            stage(C0 + ((ch + 1) & 1) * STREAM_ROWS * LDC, LDC, X + j0 + CW, r, b,
                  min(CW, r - j0 - CW), STREAM_ROWS, CW, v2);
          cp_async_commit();
          cp_async_wait<1>();
          __syncthreads();
          panel_dots<T, STREAM_ROWS>(P, LDP, Cb, LDC, CW, 8, Sp, LDC, warp, WARPS);
          __syncthreads();
          panel_solve(Sp, LDC, 8, G, LDP, D, LDC, CW, tid, THREADS);
          __syncthreads();
          panel_update<T, STREAM_ROWS>(P, LDP, D, LDC, Cb, LDC, CW, warp, WARPS);
          __syncthreads();
          unstage(Qt + j0, r, Cb, LDC, b, min(CW, r - j0), v2);
          __syncthreads();
        }
      }
      __syncthreads();
    }
  }

  // R = Q^T Y, both in 64-row slabs through the panel's and the chunks'
  // shared memory (2 x 64 x 132 words of their 22528).
  r_product<64>(static_cast<const T*>(nullptr), 0, Qt, P, Yt, P + 64 * pad_ld(rp), b, r,
                R + t * r * static_cast<long long>(r), v2);
}

// ---- The first design, for the shapes the blocked kernels do not
// take: one block a tile, the panel factored column by column with block
// barriers, each trailing column projected in registers.

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

// ---- Host side: the one place that decides which kernel runs.

// The kernel configuration for (b, r), r <= b <= 1024.
static int config(int b, int r) {
  if (b <= SMALL_ROWS) return CFG_SMEM;
  if (b <= STREAM_ROWS && r <= MAX_R) return CFG_STREAM;
  return CFG_FIRST;
}

// Whether the first design's working panel and one column panel fit in
// shared memory (else the panel lives in device scratch).
template <typename T>
static bool first_fits_smem(int b, int r) {
  return static_cast<size_t>(NB + r) * b * sizeof(T) <= SMEM_BUDGET;
}

template <typename T>
static size_t smem_bytes(int cfg, int b, int r) {
  const int rp = round_up(r, NB);
  if (cfg == CFG_SMEM)
    return (static_cast<size_t>(SMALL_ROWS + 2 * NB) * pad_ld(rp) + 2 * 4 * NB) * sizeof(T);
  if (cfg == CFG_STREAM)
    return static_cast<size_t>(STREAM_ROWS * LDP + 2 * STREAM_ROWS * LDC + 8 * NB * LDC +
                               NB * LDP + NB * LDC + 2 * (STREAM_ROWS / (32 * RPT)) * NB) *
           sizeof(T);
  return static_cast<size_t>(NB + (first_fits_smem<T>(b, r) ? r : 0)) * b * sizeof(T);
}

// Words of device scratch a tile needs: only the first design's, when its
// panels do not fit in shared memory (b = 1024, r = 40 in f64: 1024 x 40
// words). The wrapper asks here.
template <typename T>
static long long scratch_words(int b, int r) {
  if (config(b, r) != CFG_FIRST || first_fits_smem<T>(b, r)) return 0;
  return static_cast<long long>(r) * b;
}

// The opt-in is set whatever the size: a kernel's static shared memory
// counts against the 48 KB default as well.
template <class Kernel, class... Args>
static int launch(Kernel kernel, int grid, size_t smem, void* stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* Y, void* Q, void* R, void* work, int T_, int b, int r,
                    int sweeps, void* stream) {
  if (T_ == 0 || b == 0 || r == 0) return 0;
  if (r > b || b > 32 * MAXV) return static_cast<int>(cudaErrorInvalidValue);
  const int cfg = config(b, r);
  const size_t smem = smem_bytes<T>(cfg, b, r);
  const T* y = static_cast<const T*>(Y);
  T* q = static_cast<T*>(Q);
  T* rr = static_cast<T*>(R);
  if (cfg == CFG_FIRST) {
    const bool fits = first_fits_smem<T>(b, r);
    if (!fits && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch(mgs_qr_kernel<T>, T_, smem, stream, y, q, rr, static_cast<T*>(work), b, r,
                  sweeps, fits ? 1 : 0);
  }
  // Two-word copies need r even and both matrices aligned to two words.
  const uintptr_t two = 2 * sizeof(T);
  const int vec = (r % 2 == 0 && reinterpret_cast<uintptr_t>(Y) % two == 0 &&
                   reinterpret_cast<uintptr_t>(Q) % two == 0) ? 1 : 0;
  if (cfg == CFG_SMEM)
    return launch(mgs_qr_smem<T>, T_, smem, stream, y, q, rr, b, r, sweeps, vec);
  return launch(mgs_qr_stream<T>, T_, smem, stream, y, q, rr, b, r, sweeps, vec);
}

}  // namespace

extern "C" {
long long repro_batched_qr_scratch_f64(int b, int r) { return scratch_words<double>(b, r); }
long long repro_batched_qr_scratch_f32(int b, int r) { return scratch_words<float>(b, r); }
int repro_batched_qr_config_f64(int b, int r) { return config(b, r); }
int repro_batched_qr_config_f32(int b, int r) { return config(b, r); }
int repro_batched_qr_f64(const void* Y, void* Q, void* R, void* work, int T_, int b, int r,
                         int sweeps, void* stream) {
  return dispatch<double>(Y, Q, R, work, T_, b, r, sweeps, stream);
}
int repro_batched_qr_f32(const void* Y, void* Q, void* R, void* work, int T_, int b, int r,
                         int sweeps, void* stream) {
  return dispatch<float>(Y, Q, R, work, T_, b, r, sweeps, stream);
}
}
