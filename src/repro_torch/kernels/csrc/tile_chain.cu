// Batched two-product tile chain:  out[t] = U[t][:, :r] @ (V[t][:, :r]^T @ X[t]).
//
// Replaces the Pallas TPU kernel `tile_chain_pallas` / `_tile_chain_kernel`
// (src/repro/kernels/tlr_matvec.py). The TPU kernel keeps the whole (r x s)
// intermediate in VMEM; here it stays on chip too.
//
// Bound on the H100: 4*b*r*s FLOPs on (2*b*r + 2*b*s) elements per tile. At
// the main path's headline (sample_t's projection chains: T = 1890 tiles,
// b = 512, r = s = 128, f64) that is 63.4 GFLOP on 3.96 GB: 0.95 ms at the
// 67 TFLOP/s of the FP64 tensor cores, 1.18 ms at 3.35 TB/s. Arithmetic
// intensity 16.7 FLOP/byte sits just under the f64 ridge (20), so both
// limits matter: tensor cores, and every operand byte read once.
//
// f64, s > 16, r <= 128 (the headline): `tile_chain_dmma`. One 256-thread
// block per tile and 128-column chunk (grid (T, ceil(s / 128)): one chunk on
// the main path), so U, V and X are each read from device memory once. All
// products run on the FP64 tensor cores, mma.sync m16n8k8 .f64 (m8n8k4
// issues at half the rate on the H100: tools/dmma_rate.cu). Warp w owns
// output columns [16 w, 16 w + 16) of the chunk.
//   phase 1  Wt = X[:, chunk]^T V (128 x r), contraction over b: 16-row
//            slices of V and X stream through a cp.async ring; each warp
//            keeps its 16 rows of Wt, all r <= 128 columns, in registers
//            (16 accumulator fragments, 64 words a thread).
//   phase 2  out[rows, chunk]^T = Wt U[rows]^T, contraction over r: 32-row
//            slices of U (whole rows, contiguous in memory) stream through
//            the same ring. Wt's accumulator fragments are the A fragments
//            of this product as they stand, once the k slots are read as
//            r = 8 kt + 2 q and 8 kt + 2 q + 1; the B fragment is then one
//            16-byte load of a U row. Each slice's 32 output rows are
//            stored straight from the accumulators, masked at b and s.
// W never touches shared memory, so all of it (4 stages of 34 KB) holds the
// ring: three slices load while one is multiplied. V and X slices are
// XOR-swizzled and U rows padded, so fragment loads hit distinct banks.
// Copies (16 bytes where strides and pointers allow, else 8) past b, r and
// s write zeros, so ragged shapes need no padding on the host. One block per
// SM (registers and shared memory).
//
// What still separates it from the bound (PERF.md has the times): each SM
// runs one tile at a time, so a tile's ring fills from empty and the
// memory-bound phase 1 never overlaps another tile's phase 2 on the SM;
// 1890 tiles over 132 SMs leave the last of 15 waves a third full.
//
// f64, s > 16, 128 < r <= 512: `tile_chain_dmma<VEC, H>`, H = 2 (r <= 256)
// or 4. The factors of the fractional-diffusion preconditioner (compressed
// at 1e-10 with r_max = tile) reach these widths: at tile 512 its
// projection chains are (434, 512, 256, 256), 58.2 GFLOP, bound by
// operations (0.87 ms). Wt of 128 columns a warp no longer fits in
// registers, so the factor columns are split over a thread block cluster
// of H blocks per (tile, 128-column chunk): block h runs the r <= 128 kernel
// above on columns [128 h, 128 h + 128) of U and V, read in place, and the
// partial output slices (32 rows x 128 columns) pass down a chain through
// distributed shared memory, block h + 1 to block h, double-buffered and
// paced by mbarriers; block 0 adds them in a fixed order and stores. Each
// block reads half (H = 2) of U and V and one chunk of X, as the r <= 128
// kernel reads all of them. Two designs were slower at the headline (H100,
// PERF.md): Wt (64 x r) in shared memory with 64-column chunks, 1.86 ms,
// since U and V are then read four times at s = 256 and loads and
// products overlap poorly; and that with a copy warp, 2.13 ms (a ninth warp
// caps registers at 168 and one warp's cp.async cannot keep up).
//
// Every other case (f32, bf16, s <= 16, f64 past r = 512) runs
// `tile_chain_kernel`: grid (T, ceil(s / SC)), W = V^T X[:, chunk] (r x SC)
// formed in shared memory with the shared FMA tile routine (common.cuh),
// then out[:, chunk] = U W. s <= 16 (the W2 hoist, at any r) uses the
// 16-column chunk, s > 16 the 64-column one while W fits.
//
// `ldr` is the row stride of U and V: a `width=` slice (r < ldr) of the
// zero-padded factors costs nothing on the host.
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace repro;

namespace dmma {
constexpr int SC = 128;        // output columns per block
constexpr int RMAX = 128;      // factor columns the kernel takes
constexpr int THREADS = 256;   // 8 warps
constexpr int WN = SC / 8;     // output columns of one warp
constexpr int FR = RMAX / 8;   // n8 tiles (phase 1) and k8 steps (phase 2) over r
constexpr int BK1 = 16;        // phase 1 slice: BK1 rows of V and of X
constexpr int BR = 32;         // phase 2 slice: BR rows of U
constexpr int FB = BR / 8;     // its n8 tiles
constexpr int LDU = RMAX + 8;  // padded row stride of a U slice
constexpr int STAGE1 = 2 * BK1 * SC, STAGE2 = BR * LDU;
constexpr int STAGE = STAGE1 > STAGE2 ? STAGE1 : STAGE2;
constexpr int NST = 4;         // ring stages
constexpr size_t SMEM = size_t(NST) * STAGE * sizeof(double);
static_assert(SMEM <= 232448, "fits a block's shared memory");
// A cluster of H > 1 blocks (128 < r <= 128 H): the partial sums a block
// passes down the chain, two slices of FB x 4 x THREADS words, then the
// chain's full and empty mbarriers, two each.
constexpr int PART = FB * 4 * THREADS;
constexpr size_t SMEM_SPLIT = SMEM + (2 * PART + 4) * sizeof(double);
static_assert(SMEM_SPLIT <= 232448, "fits a block's shared memory");
}  // namespace dmma

// VEC = 2: 16-byte copies (ldr and s even, pointers 16-byte aligned);
// VEC = 1: 8-byte ones. H = 1: block (t, chunk), all r <= 128 columns.
// H > 1: a cluster of H blocks per (t, chunk), x = H (t nchunk + chunk) + h;
// block h takes factor columns [128 h, 128 h + 128) and passes its partial
// output slices down to block h - 1, which adds its own in front: block 0
// stores p_0 + (p_1 + (... + p_{H-1})), in the same order every call.
template <int VEC, int H>
__global__ void __launch_bounds__(dmma::THREADS, 1)
    tile_chain_dmma(const double* __restrict__ U, const double* __restrict__ V,
                    const double* __restrict__ X, double* __restrict__ out, int b, int r,
                    int ldr, int s) {
  using namespace dmma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  long long t = blockIdx.x;
  int c0 = blockIdx.y * SC, h = 0;
  if constexpr (H > 1) {
    const int nchunk = (s + SC - 1) / SC;
    h = static_cast<int>(cluster_ctarank());
    t = blockIdx.x / H / nchunk;
    c0 = static_cast<int>(blockIdx.x / H - t * nchunk) * SC;
    r = max(0, min(RMAX, r - RMAX * h));  // this block's factor columns
  }
  const double* Ut = U + t * b * static_cast<long long>(ldr) + RMAX * h;
  const double* Vt = V + t * b * static_cast<long long>(ldr) + RMAX * h;
  const double* Xt = X + t * b * static_cast<long long>(s);
  double* Ot = out + t * b * static_cast<long long>(s);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wn = warp * WN;
  const bool busy = c0 + wn < s;             // the warp's columns hold live output
  const int nkt = (min(r, RMAX) + 7) / 8;    // k8 steps of r that hold data
  // V and X slices keep rows of SC words with column n stored at n ^ 4 (k mod 4)
  // in row k: the fragment loads of a half-warp (row q + const, column
  // g + const, g, q < 4) then hit 16 distinct 8-byte banks. x0 and x8 are
  // this lane's slots for columns g and 8 + g of an aligned 16-column group.
  const int x0 = g ^ (q << 2), x8 = (8 + g) ^ (q << 2);

  // Copies: TPR1 threads a row of V and of X (column m1 + TPR1 VEC it),
  // TPR2 threads a row of U; bytes past b, r and s are zero-filled.
  constexpr int TPR1 = THREADS / BK1, TPR2 = THREADS / BR;
  const int k1 = tid / TPR1, m1 = (tid % TPR1) * VEC;
  const int i2 = tid / TPR2, m2 = (tid % TPR2) * VEC;
  const int sw1 = k1 * SC + (m1 ^ ((k1 & 3) << 2));  // swizzled slot of (k1, m1)
  auto nbytes = [](int col, int n) { return 8 * max(0, min(VEC, n - col)); };
  // Slices 0 .. n1 - 1 hold V and X (phase 1), n1 .. n - 1 hold U (phase 2).
  const int n1 = (b + BK1 - 1) / BK1, n = n1 + (b + BR - 1) / BR;
  auto load = [&](int p, double* st) {
    if (p < n1) {
      const int gk = p * BK1 + k1;
      const bool row = gk < b;
      const double* v = Vt + static_cast<long long>(gk) * ldr + m1;
      const double* x = Xt + static_cast<long long>(gk) * s + c0 + m1;
#pragma unroll
      for (int it = 0; it < SC / (TPR1 * VEC); ++it) {
        const int dm = TPR1 * VEC * it;
        const int bv = row ? nbytes(m1 + dm, r) : 0, bx = row ? nbytes(c0 + m1 + dm, s) : 0;
        cp_async<8 * VEC>(st + sw1 + dm, bv ? v + dm : Vt, bv);
        cp_async<8 * VEC>(st + BK1 * SC + sw1 + dm, bx ? x + dm : Xt, bx);
      }
    } else {
      const int gi = (p - n1) * BR + i2;
      const bool row = gi < b;
      const double* u = Ut + static_cast<long long>(gi) * ldr + m2;
#pragma unroll
      for (int it = 0; it < RMAX / (TPR2 * VEC); ++it) {
        const int dm = TPR2 * VEC * it;
        const int bu = row ? nbytes(m2 + dm, r) : 0;
        cp_async<8 * VEC>(st + i2 * LDU + m2 + dm, bu ? u + dm : Ut, bu);
      }
    }
  };
  // The ring: slice p sits in stage `cur` = p mod NST, and NST - 1 slices
  // are in flight. Past the barrier of slice p every warp is done with slice
  // p - 1, whose stage `fill` then takes slice p + NST - 1.
  int cur = 0, fill = NST - 1;
#pragma unroll
  for (int p = 0; p < NST - 1; ++p) {
    if (p < n) load(p, ring + p * STAGE);
    cp_async_commit();
  }
  auto wait_for = [&](int p) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (p + NST - 1 < n) load(p + NST - 1, ring + fill * STAGE);
    cp_async_commit();
  };
  auto advance = [&] {
    fill = cur;
    cur = cur + 1 == NST ? 0 : cur + 1;
  };

  // The chain (H > 1): part[sl] holds a partial slice passed up from block
  // h + 1, full[sl] completes when its 256 threads have written it, empty[sl]
  // (in block h + 1) when block h's threads have read it. Thread i of the
  // sender writes word k of its share at k THREADS + i, which thread i of
  // the receiver reads. The barriers are set up, and the blocks kept alive
  // until every remote access is done, by barriers of the whole cluster.
  double* part = ring + NST * STAGE;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(part + 2 * PART);
  unsigned long long* empty = full + 2;
  if constexpr (H > 1) {
    if (tid == 0) {
      for (int sl = 0; sl < 2; ++sl) {
        mbar_init(&full[sl], THREADS);
        mbar_init(&empty[sl], THREADS);
      }
      mbar_init_fence();
    }
    cluster_sync();
  }

  // Phase 1: acc[j] is the fragment of Wt rows [wn, wn + 16), columns
  // [8 j, 8 j + 8): {Wt[g][2q], Wt[g][2q + 1], Wt[g + 8][2q], Wt[g + 8][2q + 1]}.
  double acc[FR][4];
#pragma unroll
  for (int j = 0; j < FR; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.0;
  for (int p = 0; p < n1; ++p, advance()) {
    wait_for(p);
    if (!busy) continue;
    const double* sV = ring + cur * STAGE;
    const double* sX = sV + BK1 * SC;
#pragma unroll
    for (int kk = 0; kk < BK1; kk += 8) {
      double a[4];  // A = X^T: a = {X[q][g], X[q][g + 8], X[q + 4][g], X[q + 4][g + 8]}
#pragma unroll
      for (int v = 0; v < 4; ++v)
        a[v] = sX[(kk + q + 4 * (v >> 1)) * SC + wn + ((v & 1) ? x8 : x0)];
#pragma unroll
      for (int j = 0; j < FR; ++j) {
        double bf[2];  // B = V: {V[q][8 j + g], V[q + 4][8 j + g]}
#pragma unroll
        for (int v = 0; v < 2; ++v)
          bf[v] = sV[(kk + q + 4 * v) * SC + 16 * (j >> 1) + ((j & 1) ? x8 : x0)];
        mma_m16n8k8_f64(acc[j], a, bf);
      }
    }
  }

  // Phase 2: per slice, acc2[jb] = {out[i][c], out[i + 1][c], out[i][c + 8],
  // out[i + 1][c + 8]} at row i = i0 + 8 jb + 2 q, column c = c0 + wn + g.
  for (int p = n1; p < n; ++p, advance()) {
    wait_for(p);
    if (H == 1 && !busy) continue;
    const double* sU = ring + cur * STAGE + g * LDU + 2 * q;
    double acc2[FB][4];
#pragma unroll
    for (int jb = 0; jb < FB; ++jb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc2[jb][v] = 0.0;
#pragma unroll
    for (int kt = 0; kt < FR; ++kt) {
      if (kt >= nkt || !busy) break;
      const double a[4] = {acc[kt][0], acc[kt][2], acc[kt][1], acc[kt][3]};
#pragma unroll
      for (int jb = 0; jb < FB; ++jb) {
        const double2 u = *reinterpret_cast<const double2*>(sU + 8 * jb * LDU + 8 * kt);
        const double bf[2] = {u.x, u.y};
        mma_m16n8k8_f64(acc2[jb], a, bf);
      }
    }
    if constexpr (H > 1) {
      const int j = p - n1, sl = j & 1;
      double* mine = part + sl * PART + tid;
      if (h < H - 1) {  // add the partial of blocks h + 1 .. H - 1
        mbar_wait(&full[sl], (j >> 1) & 1);
#pragma unroll
        for (int jb = 0; jb < FB; ++jb)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc2[jb][v] += mine[(4 * jb + v) * THREADS];
        mbar_arrive_cluster(&empty[sl], h + 1);
      }
      if (h > 0) {  // pass the sum on to block h - 1
        if (j >= 2) mbar_wait(&empty[sl], ((j >> 1) & 1) ^ 1);
        double* theirs = cluster_map(mine, h - 1);
#pragma unroll
        for (int jb = 0; jb < FB; ++jb)
#pragma unroll
          for (int v = 0; v < 4; ++v) theirs[(4 * jb + v) * THREADS] = acc2[jb][v];
        mbar_arrive_cluster(&full[sl], h - 1);
        continue;
      }
    }
    const int i0 = (p - n1) * BR + 2 * q, col = c0 + wn + g;
#pragma unroll
    for (int jb = 0; jb < FB; ++jb)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int gi = i0 + 8 * jb + (v & 1), gc = col + 8 * (v >> 1);
        if (gi < b && gc < s) Ot[static_cast<long long>(gi) * s + gc] = acc2[jb][v];
      }
  }
  if constexpr (H > 1) cluster_sync();
}

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

template <int VEC>
static int launch_dmma(const void* U, const void* V, const void* X, void* out, int T_, int b,
                       int r, int ldr, int s, void* stream) {
  auto kernel = tile_chain_dmma<VEC, 1>;
  cudaError_t err = allow_dynamic_smem(kernel, dmma::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(T_, (s + dmma::SC - 1) / dmma::SC);
  kernel<<<grid, dmma::THREADS, dmma::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(U), static_cast<const double*>(V),
      static_cast<const double*>(X), static_cast<double*>(out), b, r, ldr, s);
  return static_cast<int>(cudaGetLastError());
}

// 128 < r <= 128 H: clusters of H blocks, one per (tile, 128-column chunk).
template <int VEC, int H>
static int launch_split(const void* U, const void* V, const void* X, void* out, int T_, int b,
                        int r, int ldr, int s, void* stream) {
  auto kernel = tile_chain_dmma<VEC, H>;
  cudaError_t err = allow_dynamic_smem(kernel, dmma::SMEM_SPLIT);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(T_) * ((s + dmma::SC - 1) / dmma::SC) * H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(dmma::THREADS);
  cfg.dynamicSmemBytes = dmma::SMEM_SPLIT;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = H;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const double*>(U),
                           static_cast<const double*>(V), static_cast<const double*>(X),
                           static_cast<double*>(out), b, r, ldr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

static bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The kernel configuration for factor width r and s output columns, chosen
// from the shapes alone: the wrapper asks for it (repro_tile_chain_config_*)
// and passes it back to the launch, which refuses any other.
enum Config { kNarrow = 0, kWide = 1, kDmma = 2, kDmmaWide = 3 };
constexpr size_t FMA_SMEM_LIMIT = 160 * 1024;  // the FMA kernel's W, r x chunk words

template <typename T>
static int config(int r, int s) {
  const size_t acc_bytes = sizeof(typename AccOf<T>::type);
  if (std::is_same_v<T, double> && s > 16 && r <= dmma::RMAX) return kDmma;
  if (std::is_same_v<T, double> && s > 16 && r <= 4 * dmma::RMAX) return kDmmaWide;
  if (s > 16 && static_cast<size_t>(r) * Wide::BN * acc_bytes <= FMA_SMEM_LIMIT) return kWide;
  if (static_cast<size_t>(r) * Narrow::BN * acc_bytes <= FMA_SMEM_LIMIT) return kNarrow;
  return -1;  // W does not fit
}

template <typename T>
static int dispatch(const void* U, const void* V, const void* X, void* out, int T_, int b,
                    int r, int ldr, int s, int cfg, void* stream) {
  if (cfg < 0 || cfg != config<T>(r, s)) return static_cast<int>(cudaErrorInvalidValue);
  if (T_ == 0 || b == 0 || s == 0) return 0;
  if constexpr (std::is_same_v<T, double>) {
    if (cfg == kDmma) {
      if (ldr % 2 == 0 && s % 2 == 0 && aligned16(U) && aligned16(V) && aligned16(X))
        return launch_dmma<2>(U, V, X, out, T_, b, r, ldr, s, stream);
      return launch_dmma<1>(U, V, X, out, T_, b, r, ldr, s, stream);
    }
    if (cfg == kDmmaWide) {
      const bool vec = ldr % 2 == 0 && s % 2 == 0 && aligned16(U) && aligned16(V) && aligned16(X);
      if (r <= 2 * dmma::RMAX)
        return vec ? launch_split<2, 2>(U, V, X, out, T_, b, r, ldr, s, stream)
                   : launch_split<1, 2>(U, V, X, out, T_, b, r, ldr, s, stream);
      return vec ? launch_split<2, 4>(U, V, X, out, T_, b, r, ldr, s, stream)
                 : launch_split<1, 4>(U, V, X, out, T_, b, r, ldr, s, stream);
    }
  }
  if (cfg == kWide) return launch<T, Wide>(U, V, X, out, T_, b, r, ldr, s, stream);
  return launch<T, Narrow>(U, V, X, out, T_, b, r, ldr, s, stream);
}

extern "C" {
int repro_tile_chain_config_f64(int r, int s) { return config<double>(r, s); }
int repro_tile_chain_config_f32(int r, int s) { return config<float>(r, s); }
int repro_tile_chain_config_bf16(int r, int s) { return config<__nv_bfloat16>(r, s); }
int repro_tile_chain_f64(const void* U, const void* V, const void* X, void* out, int T_, int b,
                         int r, int ldr, int s, int cfg, void* stream) {
  return dispatch<double>(U, V, X, out, T_, b, r, ldr, s, cfg, stream);
}
int repro_tile_chain_f32(const void* U, const void* V, const void* X, void* out, int T_, int b,
                         int r, int ldr, int s, int cfg, void* stream) {
  return dispatch<float>(U, V, X, out, T_, b, r, ldr, s, cfg, stream);
}
int repro_tile_chain_bf16(const void* U, const void* V, const void* X, void* out, int T_, int b,
                          int r, int ldr, int s, int cfg, void* stream) {
  return dispatch<__nv_bfloat16>(U, V, X, out, T_, b, r, ldr, s, cfg, stream);
}
}
