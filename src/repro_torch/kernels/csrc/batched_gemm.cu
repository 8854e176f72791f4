// Rank-masked batched GEMM:  C[t] = A[t][:, :rank_t] @ B[t][:rank_t, :].
//
// Replaces the Pallas TPU kernel `batched_gemm_pallas` / `_bgemm_kernel`
// (src/repro/kernels/batched_gemm.py). The TPU kernel multiplies the whole
// r_max-deep panel against an iota mask; here each block stops its K loop at
// K_t = min(max(rank_t, 0), k), so the padding past a tile's rank costs no
// FLOPs and no bytes (the variable-rank batch the paper got from MAGMA), and
// entries past the rank, in A's columns or B's rows, are never read: they
// may hold anything.
//
// Bound on the H100: 2*m*n*K_t FLOPs on m*K_t + K_t*n + m*n words a tile.
//   - n <= 16 (the left factorization's `sample`, T = 63, m = 512, k = 128,
//     mean rank 13.5): bytes, mostly the output and A's live columns;
//     7.7 MB, 2.3 us at 3.35 TB/s, under the launch floor.
//   - m = n = 128 (the right driver's flush densify (2016, 128, 384, 128),
//     truncation (2016, 128, 128, 128), SYRK (<= 1953, 128, 128, 128) at L's
//     ranks; the rounding pass's (2016, 512, 128, 128)): 13.7 FLOP per
//     byte at the flush densify (10.7 at the truncation), under the f64
//     ridge of 20: bytes bound it too (flush densify 1.85 GB, 0.552 ms), but
//     at 3.35 TB/s the FP64 tensor cores must run at 69 % of their 67
//     TFLOP/s to keep up, which the FMA pipes (34 TFLOP/s) cannot.
//
// f64 (every call of the port's paths): `bgemm_dmma`, on the FP64 tensor
// cores (mma.sync m16n8k8 .f64; m8n8k4 issues at half the rate,
// tools/dmma_rate.cu). One block per (t, 128-row chunk, output column
// chunk), so at m = n = 128 a block owns the whole output tile and every
// byte of A's live columns and B's live rows is read from device memory
// once. A and B stream through a cp.async ring of k slices:
//   - "Wide", n > 16: 128 x 128 outputs, 8 warps with 64 x 32 warp tiles
//     (64 accumulators a thread, so one block an SM), 32-deep slices in 3
//     stages of 64 KB;
//   - "Narrow", n <= 16: 128 x 16 outputs, 8 warps with 16 x 16 warp tiles,
//     16-deep slices in 4 stages of 18 KB; T = 63, m = 512 gives 252 blocks,
//     all resident at once.
// The loop stops at K_t rounded up to the k8 step; copies past K_t, m and n
// are zero-filled (src_bytes 0 or 8), so garbage tails never enter the
// product and ragged shapes need no padding on the host. Copies are 16
// bytes where the row strides k and n are even and the pointers 16-byte
// aligned, else 8. Shared-memory layouts keep every fragment load
// conflict-free:
//   - A slices are row-major in chunks of 2 doubles, chunk c of row i at
//     c ^ 4 (i mod 2). A k8 step reads its k slots q and q + 4 as the
//     adjacent columns 2 q and 2 q + 1, so each A fragment is two 16-byte
//     loads; B's fragment takes the same rows, so the product is unchanged.
//   - B slices are row-major, column c of row p at c ^ 4 ((p / 2) mod 4):
//     the fragment {B[2q][g], B[2q + 1][g]} of a half-warp hits 16 banks.
// The output is stored straight from the accumulators (16-byte stores where
// n is even). No split-K and no atomics: two calls give bitwise-equal C.
//
// What still separates it from the bound (PERF.md has the times and the
// ablations, compiled variants timed by tools/kernel_variants.py): at the
// flush densify, loads alone (no products) take 1.13x the bound, about 89 %
// of the card's 3.35 TB/s, and products alone (no loads) 0.97x; together
// 1.31x. The same warps issue the copies and the products, one block an SM,
// so a slice that computes late delays the next copies: 32-deep slices
// (half the barriers) gained 7 % over 16-deep ones, more stages (4 to 6)
// nothing, and a persistent grid that runs the ring on from tile to tile
// moved the flush densify under 1 % (op.round's shape 4 % faster, the
// SYRK's 4 % slower). Small T (a panel's T <= 63) leaves most SMs idle: a
// tile costs its K_t / 32 dependent slices, about 0.05 ms at k = 384.
//
// f32 and bf16 keep the first kernel, `bgemm_kernel`: plain FMA loops
// through the shared tile routine (common.cuh), grid (T, ceil(m / 64),
// ceil(n / BN)) with 16-column (n <= 16) or 64-column tiles.
//
// The configuration comes from the dtype and n alone: the wrapper asks for
// it (repro_batched_gemm_config_*) and passes it back to the launch, which
// refuses any other.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace repro;

namespace dmma {
constexpr int BM = 128;       // output rows of a block
constexpr int THREADS = 256;  // 8 warps

// BN output columns a block, BK-deep ring slices, WARPS_N of the 8 warps
// along the columns, NST ring stages, MIN_BLOCKS resident blocks an SM
// asked of the compiler.
template <int BN_, int BK_, int WARPS_N_, int NST_, int MIN_BLOCKS_>
struct Shape {
  static constexpr int BN = BN_, BK = BK_, WARPS_N = WARPS_N_, NST = NST_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WTM = BM / (8 / WARPS_N);     // warp tile rows
  static constexpr int WTN = BN / WARPS_N;           // warp tile columns
  static constexpr int MT = WTM / 16, NT = WTN / 8;  // m16 and n8 tiles of a warp
  static constexpr int STAGE_A = BM * BK, STAGE = STAGE_A + BK * BN;  // words
  static constexpr size_t SMEM = size_t(NST) * STAGE * sizeof(double);
  static_assert(MT >= 1 && NT >= 1 && BK % 16 == 0, "whole fragments, pairs of k8 steps");
  static_assert(SMEM * MIN_BLOCKS <= 232448, "fits an SM");
};
using Wide = Shape<128, 32, 4, 3, 1>;   // n > 16: warp tiles 64 x 32, 3 x 64 KB
using Narrow = Shape<16, 16, 1, 4, 2>;  // n <= 16: warp tiles 16 x 16, 4 x 18 KB

// Slot of element (row, col) of a BK-deep A slice: chunk col / 2 of the row
// sits at (col / 2) ^ 4 (row mod 2).
template <int BK, typename P>
__device__ __forceinline__ P* ring_a(P* st, int row, int col) {
  return st + row * BK + (col ^ ((row & 1) << 3));
}
}  // namespace dmma

// Block b: row tile t = b / (mchunks * nchunks), then its (128-row chunk,
// column chunk) in row-major order, so the blocks of one t are adjacent in
// the grid.
template <class S, int VEC>
__global__ void __launch_bounds__(dmma::THREADS, S::MIN_BLOCKS)
    bgemm_dmma(const double* __restrict__ A, const double* __restrict__ B,
               const int* __restrict__ ranks, double* __restrict__ C, int m, int k, int n,
               int nchunks) {
  using dmma::BM;
  using dmma::ring_a;
  constexpr int BK = S::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  const int per_t = ((m + BM - 1) / BM) * nchunks;
  const long long t = blockIdx.x / per_t;
  const int tile = static_cast<int>(blockIdx.x % per_t);
  const int i0 = (tile / nchunks) * BM;
  const int j0 = (tile % nchunks) * S::BN;
  const int K = min(max(ranks[t], 0), k);
  const double* At = A + t * m * static_cast<long long>(k);
  const double* Bt = B + t * k * static_cast<long long>(n);
  double* Ct = C + t * m * static_cast<long long>(n);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wr = (warp / S::WARPS_N) * S::WTM;  // the warp's rows and columns
  const int wc = (warp % S::WARPS_N) * S::WTN;  // in the block's tile
  const bool busy = i0 + wr < m && j0 + wc < n;
  const int nsl = (K + BK - 1) / BK;            // ring slices

  auto nbytes = [](int col, int lim) { return 8 * max(0, min(VEC, lim - col)); };
  // Slice p: A[i0 : i0 + BM, BK p : BK (p + 1)] and B[BK p : BK (p + 1),
  // j0 : j0 + BN], both zero past K, m and n.
  auto load = [&](int p, double* st) {
    const int k0 = p * BK;
    constexpr int CA = BK / VEC, CB = S::BN / VEC;  // copies a row
#pragma unroll
    for (int e = tid; e < BM * CA; e += dmma::THREADS) {
      const int row = e / CA, col = (e % CA) * VEC;
      const int gi = i0 + row;
      const int ba = gi < m ? nbytes(k0 + col, K) : 0;
      cp_async<8 * VEC>(ring_a<BK>(st, row, col),
                        ba ? At + static_cast<long long>(gi) * k + k0 + col : At, ba);
    }
#pragma unroll
    for (int e = tid; e < BK * CB; e += dmma::THREADS) {
      const int row = e / CB, col = (e % CB) * VEC;
      const int gc = j0 + col;
      const int bb = k0 + row < K ? nbytes(gc, n) : 0;
      cp_async<8 * VEC>(st + S::STAGE_A + row * S::BN + (col ^ (((row >> 1) & 3) << 2)),
                        bb ? Bt + static_cast<long long>(k0 + row) * n + gc : Bt, bb);
    }
  };

  // The ring: slice p sits in stage `cur` = p mod NST, and NST - 1 slices
  // are in flight. Past the barrier of slice p every warp is done with slice
  // p - 1, whose stage `fill` then takes slice p + NST - 1.
  int cur = 0, fill = S::NST - 1;
#pragma unroll
  for (int p = 0; p < S::NST - 1; ++p) {
    if (p < nsl) load(p, ring + p * S::STAGE);
    cp_async_commit();
  }

  // acc[mi][ni] = {C[r][c], C[r][c + 1], C[r + 8][c], C[r + 8][c + 1]} at
  // r = wr + 16 mi + g, c = wc + 8 ni + 2 q of the block's tile.
  double acc[S::MT][S::NT][4];
#pragma unroll
  for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::NT; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][ni][v] = 0.0;

  for (int p = 0; p < nsl; ++p) {
    cp_async_wait<S::NST - 2>();
    __syncthreads();
    if (p + S::NST - 1 < nsl) load(p + S::NST - 1, ring + fill * S::STAGE);
    cp_async_commit();
    if (busy) {
      const double* sA = ring + cur * S::STAGE;
      const double* sB = sA + S::STAGE_A;
      const int steps = min(BK / 8, (K - p * BK + 7) / 8);  // k8 steps that hold data
#pragma unroll
      for (int s = 0; s < BK / 8; ++s) {
        if (s >= steps) break;
        // B = {B[8s + 2q][c], B[8s + 2q + 1][c]}, c = wc + 8 ni + g: k slots
        // q and q + 4 of the step are rows 8s + 2q and 8s + 2q + 1.
        double bf[S::NT][2];
#pragma unroll
        for (int ni = 0; ni < S::NT; ++ni) {
          const int c = (wc + 8 * ni + g) ^ (q << 2);
#pragma unroll
          for (int v = 0; v < 2; ++v) bf[ni][v] = sB[(8 * s + 2 * q + v) * S::BN + c];
        }
#pragma unroll
        for (int mi = 0; mi < S::MT; ++mi) {
          // A = {A[r][2q'], A[r + 8][2q'], A[r][2q' + 1], A[r + 8][2q' + 1]},
          // 2q' = 8s + 2q: one 16-byte load of each row.
          const int r = wr + 16 * mi + g;
          const double2 x = *reinterpret_cast<const double2*>(ring_a<BK>(sA, r, 8 * s + 2 * q));
          const double2 y =
              *reinterpret_cast<const double2*>(ring_a<BK>(sA, r + 8, 8 * s + 2 * q));
          const double af[4] = {x.x, y.x, x.y, y.y};
#pragma unroll
          for (int ni = 0; ni < S::NT; ++ni) mma_m16n8k8_f64(acc[mi][ni], af, bf[ni]);
        }
      }
    }
    fill = cur;
    cur = cur + 1 == S::NST ? 0 : cur + 1;
  }
  cp_async_wait<0>();
  if (!busy) return;

#pragma unroll
  for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = i0 + wr + 16 * mi + g + 8 * h;
      if (gi >= m) continue;
      double* row = Ct + static_cast<long long>(gi) * n;
#pragma unroll
      for (int ni = 0; ni < S::NT; ++ni) {
        const int gc = j0 + wc + 8 * ni + 2 * q;
        const double v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (n % 2 == 0) {
          if (gc < n) *reinterpret_cast<double2*>(row + gc) = make_double2(v0, v1);
        } else {
          if (gc < n) row[gc] = v0;
          if (gc + 1 < n) row[gc + 1] = v1;
        }
      }
    }
}

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
static int launch_fma(const void* A, const void* B, const void* ranks, void* C, int T_, int m,
                      int k, int n, cudaStream_t stream) {
  dim3 grid(T_, (m + Cfg::BM - 1) / Cfg::BM, (n + Cfg::BN - 1) / Cfg::BN);
  bgemm_kernel<T, Cfg><<<grid, Cfg::THREADS, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<const int*>(ranks),
      static_cast<T*>(C), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <class S, int VEC>
static int launch_dmma(const void* A, const void* B, const void* ranks, void* C, int T_, int m,
                       int k, int n, cudaStream_t stream) {
  auto kernel = bgemm_dmma<S, VEC>;
  cudaError_t err = allow_dynamic_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunks = (n + S::BN - 1) / S::BN;
  const long long blocks =
      static_cast<long long>(T_) * ((m + dmma::BM - 1) / dmma::BM) * nchunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), dmma::THREADS, S::SMEM, stream>>>(
      static_cast<const double*>(A), static_cast<const double*>(B),
      static_cast<const int*>(ranks), static_cast<double*>(C), m, k, n, nchunks);
  return static_cast<int>(cudaGetLastError());
}

static bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

enum Config { kNarrow = 0, kWide = 1, kDmmaNarrow = 2, kDmmaWide = 3 };

template <typename T>
static int config(int n) {
  const bool narrow = n <= 16;
  if (std::is_same_v<T, double>) return narrow ? kDmmaNarrow : kDmmaWide;
  return narrow ? kNarrow : kWide;
}

template <typename T>
static int dispatch(const void* A, const void* B, const void* ranks, void* C, int T_, int m,
                    int k, int n, int cfg, void* stream) {
  if (cfg != config<T>(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (T_ == 0 || m == 0 || n == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, double>) {
    const bool v2 = k % 2 == 0 && n % 2 == 0 && aligned16(A) && aligned16(B);
    if (cfg == kDmmaWide)
      return v2 ? launch_dmma<dmma::Wide, 2>(A, B, ranks, C, T_, m, k, n, st)
                : launch_dmma<dmma::Wide, 1>(A, B, ranks, C, T_, m, k, n, st);
    return v2 ? launch_dmma<dmma::Narrow, 2>(A, B, ranks, C, T_, m, k, n, st)
              : launch_dmma<dmma::Narrow, 1>(A, B, ranks, C, T_, m, k, n, st);
  } else {
    if (cfg == kWide) return launch_fma<T, Wide>(A, B, ranks, C, T_, m, k, n, st);
    return launch_fma<T, Narrow>(A, B, ranks, C, T_, m, k, n, st);
  }
}

extern "C" {
int repro_batched_gemm_config_f64(int n) { return config<double>(n); }
int repro_batched_gemm_config_f32(int n) { return config<float>(n); }
int repro_batched_gemm_config_bf16(int n) { return config<__nv_bfloat16>(n); }
int repro_batched_gemm_f64(const void* A, const void* B, const void* ranks, void* C, int T_,
                           int m, int k, int n, int cfg, void* stream) {
  return dispatch<double>(A, B, ranks, C, T_, m, k, n, cfg, stream);
}
int repro_batched_gemm_f32(const void* A, const void* B, const void* ranks, void* C, int T_,
                           int m, int k, int n, int cfg, void* stream) {
  return dispatch<float>(A, B, ranks, C, T_, m, k, n, cfg, stream);
}
int repro_batched_gemm_bf16(const void* A, const void* B, const void* ranks, void* C, int T_,
                            int m, int k, int n, int cfg, void* stream) {
  return dispatch<__nv_bfloat16>(A, B, ranks, C, T_, m, k, n, cfg, stream);
}
}
