// Fused low-rank update-chain sampling (the Eq. 2 hot spot):
//
//     Y[t] = sum_j U[t, j][:, :r] @ (V[t, j][:, :r]^T @ W2[j])
//
// Replaces the Pallas TPU kernel `lr_sample_pallas` / `_lr_sample_kernel`
// (src/repro/kernels/lr_sample.py). On the TPU the j-reduction is a
// sequential "revisiting" grid axis with a VMEM accumulator; neither the
// (r x s) intermediates nor partial sums touch HBM.
//
// Bound on the H100: 4*b*r*s FLOPs per (t, j) pair on 2*b*r factor elements,
// about s/4 FLOP per f64 byte (4 at the main path's s = bs = 16) against an
// f64 ridge of about 20: the kernel is bound by the bytes of Ui and Vi, each
// of which has to be read once. Headline (T = 63, J = 30, b = 512,
// r = 128, s = 16): 1.98 GB, 0.59 ms at 3.35 TB/s.
//
// f64, r <= 512: `lr_sample_dmma<RMAX>`, RMAX = 128 for r <= 128 (every call
// of the main path), 256 or 512 past it. What held the first kernel (kept
// below for f32, bf16 and r > 512) back, and what this one does about it:
//   1. Its grid scaled with T alone, the j loop serial in the block: the
//      small-T column buckets ((1, 62): 4 blocks) left most of the 132 SMs
//      idle. Here a block takes one t and a group of jg consecutive j; the
//      host picks jg from (T, J) (`split`) so that the grid fills the card's
//      block slots in whole waves, and never has fewer than 132 blocks where
//      T * J >= 132 (the main path's buckets (63,30) .. (4,60) give 252, 256,
//      224, 232 and 240 blocks; (2,61) and (1,62) one pair a block). With
//      more than one group, each block writes its group's partial sum to a
//      workspace and `lr_sample_reduce` adds the partials in group order:
//      no atomics, two calls give bitwise-equal Y.
//   2. Every 128-row block recomputed Z = V[t,j]^T W2[j] over all b rows,
//      reading V ceil(b / 128) times. Here one block owns all rows (up to
//      512) of its t: Z is formed once per pair and Ui, Vi are each read
//      once per call for b <= 512 and s <= 16 (every call the factorizations
//      make at tile <= 512 and bs = 16). A wider s runs one block per 16-column
//      chunk, a b past 512 one block per 512 rows; sibling blocks are
//      adjacent in the grid, so their second read of a factor tile finds it
//      in L2 if anywhere.
//   3. Plain FMA loops with W in shared memory and no copy overlapping the
//      next j's loads. Here both products run on the FP64 tensor cores
//      (mma.sync m16n8k8 .f64, as tile_chain_dmma), and one cp.async ring
//      streams V, W2 and U slices continuously across the pairs of the
//      group: a pair's loads overlap the previous pair's products.
//        phase 1  Z^T = W2[j][:, chunk]^T V[t,j] (16 x r), contraction over
//                 b: 16-row slices of V and W2; warp w owns r columns
//                 [16 w, 16 w + 16). Z^T goes to shared memory (17 KB at
//                 r <= 128), never to device memory.
//        phase 2  Y^T[:, rows] += Z^T U[t,j][rows]^T, contraction over r:
//                 slices of 64 rows x 32 factor columns of U; warp w owns
//                 rows 8 w .. 8 w + 7 of every 64-row slice, so each warp
//                 keeps 64 output rows x 16 columns of the group's sum in
//                 registers across all its pairs (32 doubles a thread). The
//                 k slots of a step are read as r = 8 kt + 2 q and
//                 8 kt + 2 q + 1, so each fragment is one 16-byte load.
//   4. Bytes bound it, so the aim is the bound: 256 threads and 89 KB of
//      shared memory a block, two blocks an SM, 3 of 4 ring stages (18 KB
//      each) in flight per block.
// Past r = 128 (the fractional-diffusion preconditioner's factors,
// compressed at 1e-10 with r_max = tile: (31, 14, 512, 256, 16) at tile
// 512, 0.27 ms of bytes) the same design runs at RMAX = 256 and 512: each
// warp owns RMAX / 8 columns of Z^T in phase 1, phase 2 runs rk / 32 slices
// of U a row slice, and the phase 1 slice keeps 8 rows, not 16, so that a
// stage (17 KB at 256, 33 KB at 512) stays near a phase 2 one. Both run one
// block an SM (RMAX = 256: 101 KB and 168 registers; held to two blocks,
// 128 registers spilled and the frac path's buckets ran 1-10 % slower);
// RMAX = 512 takes 197 KB. Each width sizes its j groups by its own
// occupancy (`slots<RMAX>`).
// V and W2 slices are XOR-swizzled, U slices and Z^T laid out so that
// fragment loads hit distinct banks. Copies (16 bytes where strides and
// pointers allow, else 8) past b, r and s write zeros: ragged shapes need no
// padding on the host.
//
// Every other case (f32, bf16, f64 past r = 512) runs `lr_sample_kernel`:
// the j axis a loop inside the block with the accumulator in registers,
// W = V^T W2[j] formed per j in shared memory by the shared FMA tile
// routine (common.cuh), grid (T, ceil(s / 16), ceil(b / 128)); each row
// block recomputes W.
//
// `ldr` is the row stride of U and V: a `width=` slice (r < ldr) of the
// zero-padded factors costs nothing on the host.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace repro;

namespace dmma {
constexpr int SC = 16;              // output columns of a block (one m16 tile)
constexpr int THREADS = 256;        // 8 warps
constexpr int BROWS = 512;          // output rows of a block: 8 warps x 64
constexpr int RB = 64;              // rows of a phase 2 slice, 8 per warp
constexpr int NRB = BROWS / RB;     // phase 2 row slices: the accumulator's index
constexpr int KS = 32;              // factor columns of a phase 2 slice
constexpr int NST = 4;              // ring stages
// RMAX = 128 serves r <= 128, RMAX = 256 128 < r <= 256, RMAX = 512
// 256 < r <= 512.
template <int RMAX_>
struct Cfg {
  static constexpr int RMAX = RMAX_;                  // factor columns the kernel takes
  static constexpr int BK1 = RMAX <= 128 ? 16 : 8;    // rows of V and W2 in a phase 1 slice
  static constexpr int WN = RMAX / 8;                 // phase 1: r columns of a warp
  static constexpr int NF = WN / 8;                   // their n8 tiles
  static constexpr int STAGE1 = BK1 * (RMAX + SC), STAGE2 = RB * KS;
  static constexpr int STAGE = STAGE1 > STAGE2 ? STAGE1 : STAGE2;
  static constexpr int LDZ = RMAX + 8;                // padded row stride of Z^T
  static constexpr size_t SMEM = (size_t(NST) * STAGE + SC * LDZ) * sizeof(double);
  static constexpr int MIN_BLOCKS = RMAX <= 128 ? 2 : 1;   // blocks an SM (see above)
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "fits an SM's shared memory");
};
}  // namespace dmma

// VEC = 2: 16-byte copies (ldr and s even, pointers 16-byte aligned);
// VEC = 1: 8-byte ones. Block (x, y, z): 16-column chunk and 512-row block
// x, group y (pairs j0 = y jg .. min(J, j0 + jg) - 1), row tile t = z. Its
// sum goes to out[y][t], a (b, s) slice of Y (one group) or of the partials.
template <int VEC, int RMAX>
__global__ void __launch_bounds__(dmma::THREADS, dmma::Cfg<RMAX>::MIN_BLOCKS)
    lr_sample_dmma(const double* __restrict__ Ui, const double* __restrict__ Vi,
                   const double* __restrict__ W2, double* __restrict__ out, int T, int J,
                   int jg, int b, int r, int ldr, int s) {
  using namespace dmma;
  using C = Cfg<RMAX>;
  constexpr int BK1 = C::BK1, STAGE = C::STAGE, LDZ = C::LDZ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  double* Zt = ring + NST * STAGE;  // (SC, LDZ): Z^T of the current pair
  const int nchunk = (s + SC - 1) / SC;
  const int c0 = (blockIdx.x % nchunk) * SC;
  const int row0 = (blockIdx.x / nchunk) * BROWS;
  const long long t = blockIdx.z;
  const int j0 = blockIdx.y * jg;
  const int npair = min(jg, J - j0);
  const long long tile = static_cast<long long>(b) * ldr;
  const double* Ut = Ui + (t * J + j0) * tile;
  const double* Vt = Vi + (t * J + j0) * tile;
  const double* Wg = W2 + static_cast<long long>(j0) * b * s;
  double* Ot = out + (blockIdx.y * static_cast<long long>(T) + t) * b * s;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int rk = min(r, RMAX);
  const int n1 = (b + BK1 - 1) / BK1;               // phase 1 slices of a pair
  const int nrb = (min(BROWS, b - row0) + RB - 1) / RB;
  const int nks = (rk + KS - 1) / KS;
  const int per = n1 + nrb * nks;                   // slices of a pair
  const int n = npair * per;                        // slices of the block
  // V and W2 slices keep column n of row k at n ^ 4 (k mod 4): a half-warp's
  // fragment loads (row q + const, column g + const) hit 16 distinct banks.
  // x0 and x8 are this lane's slots for columns g and 8 + g of an aligned
  // 16-column group.
  const int x0 = g ^ (q << 2), x8 = (8 + g) ^ (q << 2);

  // Copies: TPR1 threads a row of V (column m1 + TPR1 VEC it), TPRW threads a
  // row of W2, TPR2 threads a row of a U slice, whose odd rows keep column c
  // at c ^ 8. Bytes past b, r and s are zero-filled.
  constexpr int TPR1 = THREADS / BK1, TPRW = SC / VEC, TPR2 = KS / VEC;
  constexpr int RPI2 = THREADS / TPR2;              // U rows per copy step
  const int k1 = tid / TPR1, m1 = (tid % TPR1) * VEC;
  const int kw = tid / TPRW, mw = (tid % TPRW) * VEC;
  const int i2 = tid / TPR2, m2 = (tid % TPR2) * VEC;
  const int sw1 = k1 * RMAX + (m1 ^ ((k1 & 3) << 2));
  const int sww = BK1 * RMAX + kw * SC + (mw ^ ((kw & 3) << 2));
  const int sw2 = i2 * KS + (m2 ^ ((i2 & 1) << 3));
  auto nbytes = [](int col, int lim) { return 8 * max(0, min(VEC, lim - col)); };
  // The next slice to load: pair lj, slice ll of that pair.
  int lj = 0, ll = 0, issued = 0;
  auto load_next = [&](double* st) {
    if (issued++ >= n) return;
    const long long off = lj * tile;
    if (ll < n1) {
      const int gk = ll * BK1 + k1;
      const bool row = gk < b;
      const double* v = Vt + off + static_cast<long long>(gk) * ldr + m1;
#pragma unroll
      for (int it = 0; it < RMAX / (TPR1 * VEC); ++it) {
        const int dm = TPR1 * VEC * it;
        const int bv = row ? nbytes(m1 + dm, rk) : 0;
        cp_async<8 * VEC>(st + sw1 + dm, bv ? v + dm : Vi, bv);
      }
      if (kw < BK1) {
        const int gw = ll * BK1 + kw;
        const int bw = gw < b ? nbytes(c0 + mw, s) : 0;
        const double* w = Wg + (static_cast<long long>(lj) * b + gw) * s + c0 + mw;
        cp_async<8 * VEC>(st + sww, bw ? w : W2, bw);
      }
    } else {
      const int l2 = ll - n1, rb = l2 / nks, col = (l2 - rb * nks) * KS + m2;
      const int gi = row0 + rb * RB + i2;
      const double* u = Ut + off + static_cast<long long>(gi) * ldr + col;
#pragma unroll
      for (int it = 0; it < RB / RPI2; ++it) {
        const int bu = gi + RPI2 * it < b ? nbytes(col, rk) : 0;
        cp_async<8 * VEC>(st + sw2 + RPI2 * KS * it,
                          bu ? u + static_cast<long long>(RPI2) * it * ldr : Ui, bu);
      }
    }
    if (++ll == per) {
      ll = 0;
      ++lj;
    }
  };
  // The ring: slice p sits in stage `cur` = p mod NST, and NST - 1 slices
  // are in flight. Past the barrier of slice p every warp is done with slice
  // p - 1, whose stage `fill` then takes slice p + NST - 1; the sequence
  // runs on from one pair into the next.
  int cur = 0, fill = NST - 1;
#pragma unroll
  for (int p = 0; p < NST - 1; ++p) {
    load_next(ring + p * STAGE);
    cp_async_commit();
  }
  auto next_slice = [&] {
    cp_async_wait<NST - 2>();
    __syncthreads();
    load_next(ring + fill * STAGE);
    cp_async_commit();
  };
  auto advance = [&] {
    fill = cur;
    cur = cur + 1 == NST ? 0 : cur + 1;
  };

  // acc[rb] = {Y[i][c], Y[i + 1][c], Y[i][c + 8], Y[i + 1][c + 8]} at row
  // i = row0 + 64 rb + 8 warp + 2 q, column c = c0 + g.
  double acc[NRB][4];
#pragma unroll
  for (int rb = 0; rb < NRB; ++rb)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[rb][v] = 0.0;
  const int wn = warp * C::WN;    // the warp's r columns in phase 1
  const bool busy1 = wn < rk;     // hold data
  for (int jj = 0; jj < npair; ++jj) {
    // Phase 1: z[nt] = {Zt[g][c], Zt[g][c + 1], Zt[g + 8][c], Zt[g + 8][c + 1]}
    // at r column c = wn + 8 nt + 2 q.
    double z[C::NF][4] = {};
    for (int l = 0; l < n1; ++l, advance()) {
      next_slice();
      if (!busy1) continue;
      const double* sV = ring + cur * STAGE;
      const double* sW = sV + BK1 * RMAX;
#pragma unroll
      for (int kk = 0; kk < BK1; kk += 8) {
        double a[4];  // A = W2^T: {W2[q][g], W2[q][g + 8], W2[q + 4][g], W2[q + 4][g + 8]}
#pragma unroll
        for (int v = 0; v < 4; ++v) a[v] = sW[(kk + q + 4 * (v >> 1)) * SC + ((v & 1) ? x8 : x0)];
#pragma unroll
        for (int nt = 0; nt < C::NF; ++nt) {
          double bf[2];  // B = V: {V[q][c], V[q + 4][c]}, c = wn + 8 nt + g
#pragma unroll
          for (int v = 0; v < 2; ++v)
            bf[v] = sV[(kk + q + 4 * v) * RMAX + wn + 16 * (nt >> 1) + ((nt & 1) ? x8 : x0)];
          mma_m16n8k8_f64(z[nt], a, bf);
        }
      }
    }
    // Z^T to shared memory; the barrier of the first phase 2 slice orders
    // these stores before the loads below, and that of the next pair's first
    // phase 1 slice orders the loads before the next stores.
#pragma unroll
    for (int nt = 0; nt < C::NF; ++nt) {
      double* zc = Zt + g * LDZ + wn + 8 * nt + 2 * q;
      *reinterpret_cast<double2*>(zc) = make_double2(z[nt][0], z[nt][1]);
      *reinterpret_cast<double2*>(zc + 8 * LDZ) = make_double2(z[nt][2], z[nt][3]);
    }
    // Phase 2: acc[rb] += Zt[:, slice columns] U[slice rows]^T.
    const double* zg = Zt + g * LDZ + 2 * q;
#pragma unroll
    for (int rb = 0; rb < NRB; ++rb) {
      if (rb >= nrb) break;
      for (int ks = 0; ks < nks; ++ks, advance()) {
        next_slice();
        const double* sU = ring + cur * STAGE + (8 * warp + g) * KS;
#pragma unroll
        for (int kt = 0; kt < KS / 8; ++kt) {
          const int kc = 8 * kt + 2 * q;
          const double2 u = *reinterpret_cast<const double2*>(sU + (kc ^ ((g & 1) << 3)));
          const double2 z0 = *reinterpret_cast<const double2*>(zg + ks * KS + 8 * kt);
          const double2 z8 = *reinterpret_cast<const double2*>(zg + 8 * LDZ + ks * KS + 8 * kt);
          const double a[4] = {z0.x, z8.x, z0.y, z8.y};
          const double bf[2] = {u.x, u.y};
          mma_m16n8k8_f64(acc[rb], a, bf);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int col = c0 + g;
#pragma unroll
  for (int rb = 0; rb < NRB; ++rb) {
    if (rb >= nrb) break;
    const int i = row0 + rb * RB + 8 * warp + 2 * q;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int gi = i + (v & 1), gc = col + 8 * (v >> 1);
      if (gi < b && gc < s) Ot[static_cast<long long>(gi) * s + gc] = acc[rb][v];
    }
  }
}

// Y = sum over the G groups of the partials P (G, n), in group order.
__global__ void lr_sample_reduce(const double* __restrict__ P, double* __restrict__ Y,
                                 long long n, int G) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    double v = P[e];
    for (int gr = 1; gr < G; ++gr) v += P[gr * n + e];
    Y[e] = v;
  }
}

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

// The kernel configuration for factor width r and s output columns, chosen
// from the shapes alone: the wrapper asks for it (repro_lr_sample_config_*)
// and passes it back to the launch, which refuses any other.
enum Config { kFma = 0, kDmma = 1, kDmmaWide = 2 };
constexpr size_t FMA_SMEM_LIMIT = 160 * 1024;  // the FMA kernel's W, r x 16 words

template <typename T>
static int config(int r, int s) {
  (void)s;  // every s runs in 16-column chunks
  if (std::is_same_v<T, double> && r <= dmma::Cfg<128>::RMAX) return kDmma;
  if (std::is_same_v<T, double> && r <= dmma::Cfg<512>::RMAX) return kDmmaWide;
  if (static_cast<size_t>(r) * Tall::BN * sizeof(typename AccOf<T>::type) <= FMA_SMEM_LIMIT)
    return kFma;
  return -1;  // W does not fit
}

// Block slots of the tensor-core kernel of width RMAX on the current card:
// SMs and SMs x its resident blocks an SM (two at RMAX = 128, one past it;
// each width has its own, so that each grid is sized for its own slots).
struct Slots {
  int sms = 0, total = 0;
};
template <int RMAX>
static Slots slots() {
  static Slots cached;
  if (cached.total == 0) {
    using C = dmma::Cfg<RMAX>;
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    allow_dynamic_smem(lr_sample_dmma<2, RMAX>, C::SMEM);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, lr_sample_dmma<2, RMAX>,
                                                  dmma::THREADS, C::SMEM);
    cached.sms = std::max(sms, 1);
    cached.total = cached.sms * std::max(per, 1);
  }
  return cached;
}

// The j split of the tensor-core kernel: `groups` groups of `jg` consecutive
// j for each of `tiles` (row tile, chunk, row block) items. Picks the group
// size that finishes the grid in the fewest pair-times (waves of the card's
// block slots x pairs a block), ties going to the larger group (fewer
// partials to add), among those that give at least min(tiles * J, SMs)
// blocks. J = 0 leaves one group of no pairs, whose blocks write zeros.
struct Split {
  int jg = 1, groups = 1;
};
static Split split(const Slots& sl, long long tiles, int J) {
  const long long want = std::min(tiles * J, static_cast<long long>(sl.sms));
  Split best;
  long long best_cost = LLONG_MAX;
  for (int jg = 1; jg <= J; ++jg) {
    const int G = (J + jg - 1) / jg;
    const long long blocks = tiles * G;
    if (blocks < want) continue;
    const long long cost = (blocks + sl.total - 1) / sl.total * jg;
    if (cost <= best_cost) {
      best_cost = cost;
      best = {jg, G};
    }
  }
  return best;
}

static long long dmma_tiles(int T_, int b, int s) {
  return static_cast<long long>(T_) * ((s + dmma::SC - 1) / dmma::SC) *
         ((b + dmma::BROWS - 1) / dmma::BROWS);
}

// The slots of the tensor-core kernel that takes factor width r.
static Slots slots_for(int r) {
  if (r <= dmma::Cfg<128>::RMAX) return slots<128>();
  if (r <= dmma::Cfg<256>::RMAX) return slots<256>();
  return slots<512>();
}

// Words of device workspace a call needs: the group partials (G, T, b, s) of
// the tensor-core kernels when they split j into more than one group, else 0.
template <typename T>
static long long workspace(int T_, int J, int b, int r, int s) {
  const int cfg = config<T>(r, s);
  if ((cfg != kDmma && cfg != kDmmaWide) || T_ <= 0 || J <= 0 || b <= 0 || s <= 0) return 0;
  const Split sp = split(slots_for(r), dmma_tiles(T_, b, s), J);
  return sp.groups > 1 ? static_cast<long long>(sp.groups) * T_ * b * s : 0;
}

template <int VEC, int RMAX>
static int launch_dmma(const void* Ui, const void* Vi, const void* W2, void* Y, void* work,
                       int T_, int J, int b, int r, int ldr, int s, cudaStream_t stream) {
  using C = dmma::Cfg<RMAX>;
  auto kernel = lr_sample_dmma<VEC, RMAX>;
  cudaError_t err = allow_dynamic_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Slots sl = slots<RMAX>();
  const Split sp = split(sl, dmma_tiles(T_, b, s), J);
  if (sp.groups > 1 && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  double* out = static_cast<double*>(sp.groups > 1 ? work : Y);
  dim3 grid(((s + dmma::SC - 1) / dmma::SC) * ((b + dmma::BROWS - 1) / dmma::BROWS), sp.groups,
            T_);
  kernel<<<grid, dmma::THREADS, C::SMEM, stream>>>(
      static_cast<const double*>(Ui), static_cast<const double*>(Vi),
      static_cast<const double*>(W2), out, T_, J, sp.jg, b, r, ldr, s);
  err = cudaGetLastError();
  if (err != cudaSuccess || sp.groups == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(T_) * b * s;
  const int blocks = static_cast<int>(std::min((n + 255) / 256, 8LL * sl.sms));
  lr_sample_reduce<<<blocks, 256, 0, stream>>>(out, static_cast<double*>(Y), n, sp.groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_fma(const void* Ui, const void* Vi, const void* W2, void* Y, int T_, int k,
                      int b, int r, int ldr, int s, cudaStream_t stream) {
  using Cfg = Tall;
  using Acc = typename AccOf<T>::type;
  const size_t smem = static_cast<size_t>(r) * Cfg::BN * sizeof(Acc);
  auto kernel = lr_sample_kernel<T, Cfg>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(T_, (s + Cfg::BN - 1) / Cfg::BN, (b + Cfg::BM - 1) / Cfg::BM);
  kernel<<<grid, Cfg::THREADS, smem, stream>>>(
      static_cast<const T*>(Ui), static_cast<const T*>(Vi), static_cast<const T*>(W2),
      static_cast<T*>(Y), k, b, r, ldr, s);
  return static_cast<int>(cudaGetLastError());
}

static bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
static int dispatch(const void* Ui, const void* Vi, const void* W2, void* Y, void* work, int T_,
                    int k, int b, int r, int ldr, int s, int cfg, void* stream) {
  if (cfg < 0 || cfg != config<T>(r, s)) return static_cast<int>(cudaErrorInvalidValue);
  if (T_ == 0 || b == 0 || s == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, double>) {
    const bool vec =
        ldr % 2 == 0 && s % 2 == 0 && aligned16(Ui) && aligned16(Vi) && aligned16(W2);
    if (cfg == kDmma)
      return vec ? launch_dmma<2, 128>(Ui, Vi, W2, Y, work, T_, k, b, r, ldr, s, st)
                 : launch_dmma<1, 128>(Ui, Vi, W2, Y, work, T_, k, b, r, ldr, s, st);
    if (cfg == kDmmaWide && r <= dmma::Cfg<256>::RMAX)
      return vec ? launch_dmma<2, 256>(Ui, Vi, W2, Y, work, T_, k, b, r, ldr, s, st)
                 : launch_dmma<1, 256>(Ui, Vi, W2, Y, work, T_, k, b, r, ldr, s, st);
    if (cfg == kDmmaWide)
      return vec ? launch_dmma<2, 512>(Ui, Vi, W2, Y, work, T_, k, b, r, ldr, s, st)
                 : launch_dmma<1, 512>(Ui, Vi, W2, Y, work, T_, k, b, r, ldr, s, st);
  }
  return launch_fma<T>(Ui, Vi, W2, Y, T_, k, b, r, ldr, s, st);
}

extern "C" {
int repro_lr_sample_config_f64(int r, int s) { return config<double>(r, s); }
int repro_lr_sample_config_f32(int r, int s) { return config<float>(r, s); }
int repro_lr_sample_config_bf16(int r, int s) { return config<__nv_bfloat16>(r, s); }
long long repro_lr_sample_workspace_f64(int T_, int k, int b, int r, int s) {
  return workspace<double>(T_, k, b, r, s);
}
long long repro_lr_sample_workspace_f32(int T_, int k, int b, int r, int s) {
  return workspace<float>(T_, k, b, r, s);
}
long long repro_lr_sample_workspace_bf16(int T_, int k, int b, int r, int s) {
  return workspace<__nv_bfloat16>(T_, k, b, r, s);
}
int repro_lr_sample_f64(const void* Ui, const void* Vi, const void* W2, void* Y, void* work,
                        int T_, int k, int b, int r, int ldr, int s, int cfg, void* stream) {
  return dispatch<double>(Ui, Vi, W2, Y, work, T_, k, b, r, ldr, s, cfg, stream);
}
int repro_lr_sample_f32(const void* Ui, const void* Vi, const void* W2, void* Y, void* work,
                        int T_, int k, int b, int r, int ldr, int s, int cfg, void* stream) {
  return dispatch<float>(Ui, Vi, W2, Y, work, T_, k, b, r, ldr, s, cfg, stream);
}
int repro_lr_sample_bf16(const void* Ui, const void* Vi, const void* W2, void* Y, void* work,
                         int T_, int k, int b, int r, int ldr, int s, int cfg, void* stream) {
  return dispatch<__nv_bfloat16>(Ui, Vi, W2, Y, work, T_, k, b, r, ldr, s, cfg, stream);
}
}
