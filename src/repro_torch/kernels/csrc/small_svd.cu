// Batched SVD of small cores by one-sided Jacobi rotations:
//   M (T, m, n), n <= m  ->  U (T, m, n), s (T, n), V (T, n, n),
//   M[t] = U diag(s) V^T, values unsorted (the dispatcher sorts them).
//
// Replaces the Pallas TPU kernel `small_svd_pallas` / `_jacobi_svd_kernel`
// (src/repro/kernels/small_svd.py). Same rotations: alpha, beta, gamma are
// the two columns' squared norms and inner product, the angle is theta =
// atan2(2 gamma, alpha - beta) / 2, the rotation is skipped when |gamma| <=
// tiny, and it is applied to the working matrix and to the accumulated V.
// After `sweeps` sweeps (8) the column norms are s, U is the normalised
// columns (zeroed where s <= tiny), and V is returned, not V^H.
//
// Order. The rotations are the TPU kernel's, in its row-cyclic order,
// regrouped into wavefront stages: pair (p, q) of sweep k runs at stage
// k L + 2p + q, L = 2n - 1. Pairs of one stage share no column, and every
// pair sharing a column with (p, q) that comes before it in the row-cyclic
// sequence sits in an earlier stage, so the stages in order do exactly the
// row-cyclic rotations; only the dot products' summation order (and the
// last bits of each angle) differ. (A round-robin tournament needed about
// 16 sweeps on the graded R factors of the rounding pass, where row-cyclic
// needs 8.) Sweeps overlap: at n = 128 a tile takes 17n - 12 = 2164 stages
// of up to 43 pairs, not 8 (3n - 5) = 3032. The plain version in
// small_svd.py runs the same stages and the same angle formula.
//
// Bound on the H100: 8 sweeps of n(n-1)/2 rotations at 12 m + 6 n FLOPs each
// (three dot products, the rotation of two columns of A and of two of V):
// at (2016, 128, 128) 3.02e11 FLOP, 4.51 ms at the FP64 tensor-core peak
// (67 TFLOP/s) and 9.0 ms on the FP64 pipes outside the tensor cores (34
// TFLOP/s), which are the ones a rotation runs on; the bytes (0.5 GB) take
// 0.16 ms. A rotation sequence is not a matrix product, so the tensor cores
// do not apply; and the sequence is a chain: a tile's 2164 stages are each
// one pair's dependent latency (load, dot products, reduction, angle,
// rotation, store) however many SMs there are.
//
// What held the first design back: one 512-thread block a tile,
// one warp a pair, 3032 stages each ending in a block barrier, so a stage
// cost a pair's latency times ceil(pairs / 16) warp rounds; f64 atan2 and
// sincos on that path; and V rotated alongside A in device memory (L2), 4 KB
// of traffic a rotation, 266 MB a tile, transposed in place at the end.
//
// The design for m <= 128 (`jacobi_svd_rows`), every shape of the rounding
// pass and of the right-looking driver at tile 128:
//  - Angles without trigonometry (`rotation`): c = sqrt((1 + u) / 2) and
//    s = (v / 2) / c for x >= 0, else s = +-sqrt((1 - u) / 2), c = (v / 2)
//    / s, with u, v = (x, y) / hypot(x, y): two reciprocal square roots.
//  - Every warp on every stage: a pair takes 8 lanes (a quarter warp), so 64
//    pair slots cover a stage's at most 43 pairs in one round. A lane holds
//    16 rows of each column, loaded as 16-byte vectors (8 lanes read 128
//    contiguous bytes, so a warp's loads take the minimum four wavefronts);
//    the sums reduce in three shuffles.
//  - Half the bytes a stage: the pairs of sweep k's row p, (p, p+1) .. (p,
//    n-1), run in consecutive stages, so a slot keeps column p in registers
//    for the whole row and moves only column q through shared memory (row r
//    = k (n - 1) + p goes to slot r mod 64; no two live rows share a slot).
//  - Half the barriers: with L = 2n - 1 (not the least offset, 2n - 2), any
//    two pairs of different slots that share a column are at least two
//    stages apart, so one barrier every second stage orders them.
//  - V out of the rotation loop: V never feeds an angle, so the A phase
//    rotates only A and writes each rotation's (c, s) to a log in device
//    memory (16 B a rotation in f64, 1.04 MB a tile at n = 128). After s and
//    U are written, the same shared memory holds V^T, from I, and one thread
//    a row replays the log onto it: rows of V are independent, so the replay
//    needs no barrier between rotations. It takes the log in units of 8 rows
//    p0 .. p0+7 of a sweep -- the pairs among them first, then for each
//    q > p0 + 7 the pairs (p0, q) .. (p0+7, q) -- which keeps the row-cyclic
//    order of every pair that shares a column; the 8 columns p stay in
//    registers, so a V element moves through shared memory once per unit,
//    not once per rotation, and four columns q at a time give four
//    independent chains. The A phase writes the log in that order, and the
//    replay prefetches unit u + 1 with cp.async while it applies unit u.
//    V is written out once, as V[i, j].
//  - Persistent blocks: min(T, resident blocks x SMs) blocks walk the tiles
//    t = blockIdx.x, t += gridDim.x, each reusing one log slot, so the log
//    scratch is O(SMs) (137 MB at n = 128 in f64), not O(T). The wrapper
//    allocates it at the size `workspace` reports.
// On the H100 (NVIDIA H100 80GB HBM3, 700 W) a 128 x 128 f64 tile takes
// about 2.7 ms on one SM, ~86 % of it in the A phase's stages; f64 fills one
// block an SM (166 KB of shared memory), f32 two.
// Larger cores (m > 128) keep the first design (`jacobi_svd_kernel`, with
// the same `rotation`): A in shared memory when m n words fit in 200 KB,
// else in a device scratch of m n words a tile.
#include <algorithm>
#include <cfloat>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr size_t SMEM_BUDGET = 200 * 1024;

// Paths, as `path<T>(m, n)` chooses them.
enum { kRows = 0, kSmem = 1, kScratch = 2 };

__device__ __forceinline__ double tiny_of(double) { return DBL_MIN; }
__device__ __forceinline__ float tiny_of(float) { return FLT_MIN; }

// The range of x^2 + y^2 in which no square overflows and the larger one
// keeps its precision.
template <typename T> struct Range;
template <> struct Range<double> {
  static constexpr double hi = 0x1p1000, lo = 0x1p-1000;
};
template <> struct Range<float> {
  static constexpr float hi = 0x1p120f, lo = 0x1p-120f;
};

// The rotation that zeroes the inner product of two columns: (c, s) =
// (cos theta, sin theta), theta = atan2(2 gamma, alpha - beta) / 2, in
// (-pi/2, pi/2] with c >= 0; (1, 0) when |gamma| <= tiny. The formula of
// small_svd.py's `rotation`, with 1 / rho and 1 / sqrt((1 +- u) / 2) as
// reciprocal square roots (a hardware approximation refined by Newton
// steps, in place of a hypot, three divisions and a square root). Where
// x^2 + y^2 leaves its range (tested beside the first root, off the
// critical path), x and y are first scaled by a power of two.
template <typename T>
__device__ __forceinline__ void rotation(T alpha, T beta, T gamma, T& c, T& s) {
  if (!(fabs(gamma) > tiny_of(T(0)))) {
    c = T(1);
    s = T(0);
    return;
  }
  T x = alpha - beta, y = T(2) * gamma;
  const T a = x * x + y * y;
  T r = rsqrt(a);  // 1 / rho
  if (!(a >= Range<T>::lo && a <= Range<T>::hi)) {
    int e;
    frexp(fmax(fabs(x), fabs(y)), &e);
    x = ldexp(x, -e);
    y = ldexp(y, -e);
    r = rsqrt(x * x + y * y);
  }
  const T u = x * r, v = y * r;
  const T w = x >= T(0) ? T(0.5) + T(0.5) * u : T(0.5) - T(0.5) * u;
  const T rw = rsqrt(w);
  if (x >= T(0)) {
    c = w * rw;  // sqrt((1 + u) / 2)
    s = T(0.5) * v * rw;
  } else {
    s = copysign(w * rw, v);  // +-sqrt((1 - u) / 2)
    c = T(0.5) * fabs(v) * rw;
  }
}

// ---- first design: m > 128 --------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void rotate(T* __restrict__ x, T* __restrict__ y, int len, T c, T s,
                                       int lane) {
  for (int i = lane; i < len; i += 32) {
    const T a = x[i], b = y[i];
    x[i] = c * a + s * b;
    y[i] = -s * a + c * b;
  }
}

// One block of 512 threads a tile, one warp a pair of the stage, the
// working matrix transposed (column j contiguous) in shared memory or in
// the device scratch `work`, V accumulated transposed in the V output and
// transposed in place at the end. Stages 1 .. 3n - 5 of each sweep.
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
        T cs, sn;
        rotation(alpha, beta, gamma, cs, sn);
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

// ---- m <= 128: quarter-warp pair slots, V replayed from a rotation log ----------------------

namespace rows {
constexpr int LANES = 8;                 // lanes a pair
constexpr int SLOTS = THREADS / LANES;   // pair slots: 64
constexpr int MAXM = 128;                // rows a column
constexpr int RPL = MAXM / LANES;        // rows of a column a lane holds: 16
constexpr int RB = 8;                    // rows p of a replay unit
constexpr int QB = 4;                    // columns q a replay step takes
}  // namespace rows

// 16-byte vectors: VEC<T> elements.
template <typename T> constexpr int VEC = 16 / static_cast<int>(sizeof(T));
__device__ __forceinline__ void load16(double* d, const double* s) {
  const double2 v = *reinterpret_cast<const double2*>(s);
  d[0] = v.x;
  d[1] = v.y;
}
__device__ __forceinline__ void load16(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ __forceinline__ void store16(double* d, const double* s) {
  *reinterpret_cast<double2*>(d) = make_double2(s[0], s[1]);
}
__device__ __forceinline__ void store16(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
}
// A (c, s) log entry.
__device__ __forceinline__ void store_cs(double* d, double c, double s) {
  *reinterpret_cast<double2*>(d) = make_double2(c, s);
}
__device__ __forceinline__ void store_cs(float* d, float c, float s) {
  *reinterpret_cast<float2*>(d) = make_float2(c, s);
}
__device__ __forceinline__ void load_cs(const double* e, double& c, double& s) {
  const double2 v = *reinterpret_cast<const double2*>(e);
  c = v.x;
  s = v.y;
}
__device__ __forceinline__ void load_cs(const float* e, float& c, float& s) {
  const float2 v = *reinterpret_cast<const float2*>(e);
  c = v.x;
  s = v.y;
}

// Shared-memory layout of `jacobi_svd_rows` (elements of T):
//   work: A^T, A[j * ldm + i] (rows m .. rows - 1 zero), later V^T,
//         Vt[j * ldv + i]; max(ldm n, n ldv) rounded up to a vector;
//   ring: two buffers of `unit` (c, s) entries (a replay unit's log, plus
//         room to start at a 16-byte boundary);
//   sv:   the n singular values.
// ldm = rows + VEC: columns start 16 bytes apart modulo 128, so the
// transposing loads and stores of M and U conflict at most 4-way; ldv = n + 1
// does the same for V.
template <typename T>
struct Geom {
  int n, rows, ldm, ldv, work, unit, npairs;
  __host__ __device__ Geom(int m, int n_) : n(n_) {
    constexpr int CH = rows::LANES * VEC<T>;
    rows = (m + CH - 1) / CH * CH;
    ldm = rows + VEC<T>;
    ldv = n + 1;
    const int w = ldm * n > n * ldv ? ldm * n : n * ldv;
    work = (w + VEC<T> - 1) / VEC<T> * VEC<T>;
    unit = rows::RB * (n > 1 ? n - 1 : 1) + VEC<T>;
    npairs = n * (n - 1) / 2;
  }
  __host__ __device__ size_t smem_bytes() const {
    return (static_cast<size_t>(work) + 4 * unit + n) * sizeof(T);
  }
  // Log entries of a tile, and the entries between two blocks' logs (even,
  // so that every block's log starts on 16 bytes).
  __host__ __device__ long long log_entries(int sweeps) const {
    return static_cast<long long>(sweeps > 0 ? sweeps : 0) * npairs;
  }
  __host__ __device__ long long log_stride(int sweeps) const {
    return (log_entries(sweeps) + 1) / 2 * 2;
  }
};

// Replay unit b of a sweep: rows p0 = b RB .. p0 + nb - 1, its first log
// entry within the sweep and its number of entries.
struct Unit {
  int p0, nb, start, size;
};
__device__ __forceinline__ Unit unit_of(int b, int n) {
  Unit u;
  u.p0 = b * rows::RB;
  u.nb = min(rows::RB, n - 1 - u.p0);
  u.start = u.p0 * (n - 1) - u.p0 * (u.p0 - 1) / 2;
  u.size = u.nb * (n - 1 - u.p0) - u.nb * (u.nb - 1) / 2;
  return u;
}

// Queues the copy of log entries [first, first + count) of `log` (which
// holds `total` entries) into `buf` from the 16-byte boundary at or below
// `first`; returns the offset of entry `first` in `buf`. Threads tid < nt.
template <typename T>
__device__ __forceinline__ int copy_unit(T* buf, const T* log, long long first, int count,
                                         long long total, int tid, int nt) {
  constexpr int EPC = 16 / (2 * static_cast<int>(sizeof(T)));  // entries a 16-byte copy
  const long long base = first / EPC * EPC;
  const int off = static_cast<int>(first - base);
  const int chunks = (off + count + EPC - 1) / EPC;
  for (int c = tid; c < chunks; c += nt) {
    const long long e = base + static_cast<long long>(c) * EPC;
    const long long left = total - e;
    const int bytes = left >= EPC ? 16 : static_cast<int>(left) * 2 * static_cast<int>(sizeof(T));
    cp_async<16>(buf + 2 * c * EPC, log + 2 * e, bytes);
  }
  return off;
}

// Named barrier for the first nt threads (a multiple of 32).
__device__ __forceinline__ void bar_first(int nt) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
}

// One step of a replay unit: columns q0 .. q0 + QB - 1 (those below n when
// !WHOLE) against the unit's rows a < nb, pair (a, q) after (a, q - 1) and
// (a - 1, q), the order of the pairs that share a column; the entries are
// q-major from e.
template <typename T, bool FULL, bool WHOLE>
__device__ __forceinline__ void replay_step(T* Vt, int ldv, int i, int n, const T* e, int q0,
                                            T (&vp)[rows::RB], int nb_) {
  using namespace rows;
  const int nb = FULL ? RB : nb_;
  T y[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j)
    if (WHOLE || q0 + j < n) y[j] = Vt[(q0 + j) * ldv + i];
#pragma unroll
  for (int a = 0; a < RB; ++a)
#pragma unroll
    for (int j = 0; j < QB; ++j)
      if (a < nb && (WHOLE || q0 + j < n)) {
        T c, s;
        load_cs(e + 2 * (j * nb + a), c, s);
        const T x = vp[a];
        vp[a] = c * x + s * y[j];
        y[j] = -s * x + c * y[j];
      }
#pragma unroll
  for (int j = 0; j < QB; ++j)
    if (WHOLE || q0 + j < n) Vt[(q0 + j) * ldv + i] = y[j];
}

// Replays one unit (rows p0 .. p0 + nb - 1 of a sweep, log entries from e)
// onto row i of V^T: the pairs among the unit's rows in row-cyclic order,
// then the columns q >= p0 + nb, QB at a time. FULL: nb == RB, so that no
// rotation sits behind a guard and the steps' QB independent chains
// interleave.
template <typename T, bool FULL>
__device__ __forceinline__ void replay_unit(T* Vt, int ldv, int i, int n, const T* e, int p0,
                                            int nb_) {
  using namespace rows;
  const int nb = FULL ? RB : nb_;
  T vp[RB];
#pragma unroll
  for (int a = 0; a < RB; ++a)
    if (a < nb) vp[a] = Vt[(p0 + a) * ldv + i];
#pragma unroll
  for (int a = 0; a < RB; ++a)
#pragma unroll
    for (int b = a + 1; b < RB; ++b)
      if (b < nb) {
        T c, s;
        load_cs(e, c, s);
        e += 2;
        const T x = vp[a], y = vp[b];
        vp[a] = c * x + s * y;
        vp[b] = -s * x + c * y;
      }
  int q0 = p0 + nb;
  for (; q0 + QB <= n; q0 += QB, e += 2 * QB * nb)
    replay_step<T, FULL, true>(Vt, ldv, i, n, e, q0, vp, nb);
  if (q0 < n) replay_step<T, FULL, false>(Vt, ldv, i, n, e, q0, vp, nb);
#pragma unroll
  for (int a = 0; a < RB; ++a)
    if (a < nb) Vt[(p0 + a) * ldv + i] = vp[a];
}

template <typename T, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    jacobi_svd_rows(const T* __restrict__ M, T* __restrict__ U, T* __restrict__ S,
                    T* __restrict__ V, T* __restrict__ logs, int T_, int m, int n, int sweeps) {
  using namespace rows;
  constexpr int NV = VEC<T>;
  constexpr int NVEC = RPL / NV;  // vectors of a column a lane holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geom<T> g(m, n);
  T* A = reinterpret_cast<T*>(smem_raw);
  T* ring = A + g.work;
  T* sv = ring + 4 * g.unit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = tid / LANES, l8 = tid % LANES;
  const T tiny = tiny_of(T(0));
  const int nvec = g.rows / (LANES * NV);
  const int nrows = n - 1;  // rows p of a sweep
  const int L = 2 * n - 1;  // stages from one sweep's start to the next one's
  const int nstages = (n < 2 || sweeps < 1) ? 0 : (sweeps - 1) * L + 3 * n - 5;
  const int total_rows = n < 2 ? 0 : sweeps * nrows;
  const long long nlog = g.log_entries(sweeps);
  T* log = logs + 2 * g.log_stride(sweeps) * blockIdx.x;
  const int nv = (n + 31) / 32 * 32;  // threads of the replay
  const int units_sweep = (nrows + RB - 1) / RB;
  const int units = n < 2 ? 0 : sweeps * units_sweep;

  for (long long t = blockIdx.x; t < T_; t += gridDim.x) {
    const T* Mt = M + t * m * static_cast<long long>(n);
    // A[j * ldm + i] = M[i, j]; rows m .. rows - 1 zero.
    for (int e = tid; e < m * n; e += THREADS) A[(e % n) * g.ldm + e / n] = Mt[e];
    for (int e = tid; e < (g.rows - m) * n; e += THREADS)
      A[(e % n) * g.ldm + m + e / n] = T(0);
    __syncthreads();

    // ---- A phase: stage st runs, in the slot of row r = k (n-1) + p, pair
    // (p, q = st - k L - 2p) while p < q < n; a warp without a pair in the
    // stage goes straight to its barrier.
    T xp[RPL], xq[RPL];
#pragma unroll
    for (int e = 0; e < RPL; ++e) xp[e] = xq[e] = T(0);
    int r = slot, k = 0, p = 0, first = 0;
    // The log index of the row's next pair in its unit's replay order (the
    // pairs among the unit's rows row by row, then q-major): +1 while q is
    // a row of the unit, then +nb; `qmajor` is the index of (p, p0 + nb).
    long long pos = 0, qmajor = 0;
    int qend = 0, nb = 0;  // the unit's rows end at column qend = p0 + nb
    auto set_row = [&]() {
      k = r / nrows;
      p = r - k * nrows;
      first = k * L + 3 * p + 1;
      const Unit u = unit_of(p / RB, n);
      const int i = p - u.p0;
      nb = u.nb;
      qend = u.p0 + nb;
      const long long base = k * static_cast<long long>(g.npairs) + u.start;
      qmajor = base + nb * (nb - 1) / 2 + i;
      pos = p + 1 < qend ? base + i * nb - i * (i + 1) / 2 : qmajor;
    };
    if (r < total_rows) set_row();
    for (int st = 1; st <= nstages; ++st) {
      const bool active = r < total_rows && st >= first;
      if (__any_sync(0xffffffffu, active)) {
        const int q = st - k * L - 2 * p;
        if (active) {
          if (q == p + 1) {
            const T* ap = A + p * g.ldm;
#pragma unroll
            for (int v = 0; v < NVEC; ++v)
              if (v < nvec) load16(xp + v * NV, ap + (v * LANES + l8) * NV);
          }
          const T* aq = A + q * g.ldm;
#pragma unroll
          for (int v = 0; v < NVEC; ++v)
            if (v < nvec) load16(xq + v * NV, aq + (v * LANES + l8) * NV);
        }
        // alpha, beta, gamma: one partial sum per vector component, then the
        // 8 lanes of the slot.
        T sa[NV], sb[NV], sg[NV];
#pragma unroll
        for (int e = 0; e < NV; ++e) sa[e] = sb[e] = sg[e] = T(0);
#pragma unroll
        for (int v = 0; v < NVEC; ++v) {
          if (v < nvec) {
#pragma unroll
            for (int e = 0; e < NV; ++e) {
              const T x = xp[v * NV + e], y = xq[v * NV + e];
              sa[e] = fma_acc(x, x, sa[e]);
              sb[e] = fma_acc(y, y, sb[e]);
              sg[e] = fma_acc(x, y, sg[e]);
            }
          }
        }
#pragma unroll
        for (int w = NV / 2; w > 0; w /= 2)
#pragma unroll
          for (int e = 0; e < w; ++e) {
            sa[e] += sa[e + w];
            sb[e] += sb[e + w];
            sg[e] += sg[e + w];
          }
        T alpha = sa[0], beta = sb[0], gamma = sg[0];
#pragma unroll
        for (int o = LANES / 2; o > 0; o >>= 1) {
          alpha += __shfl_xor_sync(0xffffffffu, alpha, o);
          beta += __shfl_xor_sync(0xffffffffu, beta, o);
          gamma += __shfl_xor_sync(0xffffffffu, gamma, o);
        }
        T c, s;
        rotation(alpha, beta, gamma, c, s);
        if (active) {
#pragma unroll
          for (int v = 0; v < NVEC; ++v) {
            if (v < nvec) {
#pragma unroll
              for (int e = 0; e < NV; ++e) {
                const T x = xp[v * NV + e], y = xq[v * NV + e];
                xp[v * NV + e] = c * x + s * y;
                xq[v * NV + e] = -s * x + c * y;
              }
            }
          }
          T* aq = A + q * g.ldm;
#pragma unroll
          for (int v = 0; v < NVEC; ++v)
            if (v < nvec) store16(aq + (v * LANES + l8) * NV, xq + v * NV);
          if (q == n - 1) {
            T* ap = A + p * g.ldm;
#pragma unroll
            for (int v = 0; v < NVEC; ++v)
              if (v < nvec) store16(ap + (v * LANES + l8) * NV, xp + v * NV);
          }
          if (l8 == 0) store_cs(log + 2 * pos, c, s);
          pos = q + 1 < qend ? pos + 1 : (q + 1 == qend ? qmajor : pos + nb);
          if (q == n - 1) {
            r += SLOTS;
            if (r < total_rows) set_row();
          }
        }
      }
      // Pairs that share a column with another slot's sit at least two
      // stages apart, so a barrier after every second stage orders them.
      if ((st & 1) == 0 || st == nstages) __syncthreads();
    }

    // Start fetching the replay's first unit while s and U are written.
    int off0 = 0;
    if (tid < nv && units > 0) {
      const Unit u = unit_of(0, n);
      off0 = copy_unit(ring, log, u.start, u.size, nlog, tid, nv);
    }
    cp_async_commit();

    // ---- s = column norms; U = normalised columns, zeroed where s <= tiny.
    T* St = S + t * n;
    for (int j = warp; j < n; j += WARPS) {
      T ss = T(0);
      for (int i = lane; i < m; i += 32) ss = fma_acc(A[j * g.ldm + i], A[j * g.ldm + i], ss);
      ss = warp_sum(ss);
      if (lane == 0) {
        sv[j] = sqrt(ss);
        St[j] = sv[j];
      }
    }
    __syncthreads();
    T* Ut = U + t * m * static_cast<long long>(n);
    for (int e = tid; e < m * n; e += THREADS) {
      const int i = e / n, j = e % n;
      const T sj = sv[j];
      Ut[e] = sj > tiny ? A[j * g.ldm + i] / fmax(sj, tiny) : T(0);
    }
    __syncthreads();

    // ---- V phase: Vt = I, then thread i replays the log onto row i.
    T* Vt = A;
    for (int e = tid; e < n * g.ldv; e += THREADS) {
      const int j = e / g.ldv, i = e % g.ldv;
      Vt[e] = i == j ? T(1) : T(0);
    }
    __syncthreads();
    if (tid < nv) {
      const int i = tid;
      int off = off0;
      for (int uu = 0; uu < units; ++uu) {
        cp_async_wait<0>();
        bar_first(nv);  // unit uu has landed; every thread is done with uu - 1
        const int kk = uu / units_sweep;
        const Unit u = unit_of(uu - kk * units_sweep, n);
        int off_next = 0;
        if (uu + 1 < units) {
          const int k1 = (uu + 1) / units_sweep;
          const Unit u1 = unit_of(uu + 1 - k1 * units_sweep, n);
          off_next = copy_unit(ring + 2 * ((uu + 1) & 1) * g.unit, log,
                               k1 * static_cast<long long>(g.npairs) + u1.start, u1.size, nlog,
                               tid, nv);
        }
        cp_async_commit();
        if (i < n) {
          const T* e = ring + 2 * (uu & 1) * g.unit + 2 * off;
          if (u.nb == RB)
            replay_unit<T, true>(Vt, g.ldv, i, n, e, u.p0, RB);
          else
            replay_unit<T, false>(Vt, g.ldv, i, n, e, u.p0, u.nb);
        }
        off = off_next;
      }
      (void)off;
    }
    cp_async_wait<0>();
    __syncthreads();
    // V[i, j] = Vt[j * ldv + i]
    T* Vout = V + t * n * static_cast<long long>(n);
    for (int e = tid; e < n * n; e += THREADS) {
      const int i = e / n, j = e % n;
      Vout[e] = Vt[j * g.ldv + i];
    }
    __syncthreads();
  }
}

// ---- host side ---------------------------------------------------------------------------

template <typename T>
static int path(int m, int n) {
  if (m <= rows::MAXM) return kRows;
  return static_cast<size_t>(m) * n * sizeof(T) <= SMEM_BUDGET ? kSmem : kScratch;
}

// Resident blocks per SM of the f64 kernel are set by its shared memory at
// n = 128; f32 fits two.
template <typename T> constexpr int MINB = sizeof(T) == 8 ? 1 : 2;

// Blocks of the persistent kernel: min(T, resident blocks x SMs).
template <typename T>
static int rows_grid(int T_, int m, int n) {
  auto kernel = jacobi_svd_rows<T, MINB<T>>;
  const size_t smem = Geom<T>(m, n).smem_bytes();
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  allow_dynamic_smem(kernel, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, THREADS, smem);
  const long long slots = static_cast<long long>(std::max(sms, 1)) * std::max(per, 1);
  return static_cast<int>(std::min<long long>(T_, slots));
}

// Words of device workspace a call needs: the rotation logs of the
// persistent blocks (m <= 128), the working matrices of a call whose cores
// do not fit in shared memory, else 0. The one place that decides where the
// working matrix lives; the wrapper asks it.
template <typename T>
static long long workspace(int T_, int m, int n, int sweeps) {
  if (T_ <= 0 || n <= 0 || n > m) return 0;
  switch (path<T>(m, n)) {
    case kRows:
      return 2 * Geom<T>(m, n).log_stride(sweeps) * rows_grid<T>(T_, m, n);
    case kScratch:
      return static_cast<long long>(T_) * m * n;
    default:
      return 0;
  }
}

template <typename T>
static int dispatch(const void* M, void* U, void* S, void* V, void* work, int T_, int m, int n,
                    int sweeps, void* stream) {
  if (T_ == 0 || n == 0) return 0;
  if (n > m) return static_cast<int>(cudaErrorInvalidValue);
  if (workspace<T>(T_, m, n, sweeps) > 0 && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pth = path<T>(m, n);
  if (pth == kRows) {
    auto kernel = jacobi_svd_rows<T, MINB<T>>;
    const size_t smem = Geom<T>(m, n).smem_bytes();
    cudaError_t err = allow_dynamic_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<rows_grid<T>(T_, m, n), THREADS, smem, st>>>(
        static_cast<const T*>(M), static_cast<T*>(U), static_cast<T*>(S), static_cast<T*>(V),
        static_cast<T*>(work), T_, m, n, sweeps);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = pth == kSmem ? static_cast<size_t>(m) * n * sizeof(T) : 0;
  cudaError_t err = allow_dynamic_smem(jacobi_svd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  jacobi_svd_kernel<T><<<T_, THREADS, smem, st>>>(
      static_cast<const T*>(M), static_cast<T*>(U), static_cast<T*>(S), static_cast<T*>(V),
      static_cast<T*>(work), m, n, sweeps, pth == kSmem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {
long long repro_small_svd_workspace_f64(int T_, int m, int n, int sweeps) {
  return workspace<double>(T_, m, n, sweeps);
}
long long repro_small_svd_workspace_f32(int T_, int m, int n, int sweeps) {
  return workspace<float>(T_, m, n, sweeps);
}
int repro_small_svd_f64(const void* M, void* U, void* S, void* V, void* work, int T_, int m,
                        int n, int sweeps, void* stream) {
  return dispatch<double>(M, U, S, V, work, T_, m, n, sweeps, stream);
}
int repro_small_svd_f32(const void* M, void* U, void* S, void* V, void* work, int T_, int m,
                        int n, int sweeps, void* stream) {
  return dispatch<float>(M, U, S, V, work, T_, m, n, sweeps, stream);
}
}
