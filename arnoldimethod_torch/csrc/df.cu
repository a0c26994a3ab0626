// Double-word kernels of the extended-precision Arnoldi path, for NVIDIA
// Hopper (sm_90a).  A value is the unevaluated sum hi + lo of two words of
// type T (float or double); every kernel is templated on T.
//
//   df_project       c[j] = sum_i V[j, i] * w[i] for rows j < rows, zero
//                    beyond; optionally acc[j] <- acc[j] + c[j]
//   df_axpy          out = w - sum_{j < rows} h_j * V[j], j in order; in
//                    its gathered form h is a row-sharded solve's sum over
//                    the ranks, folded from the gathered partials
//   df_normalize     out = w / ||w|| for the norm of a double-word sum of
//                    squares on the card; in its step form it also makes
//                    the DGKS step's two decisions (second pass, breakdown)
//                    and writes the step's H column and breakdown flag; the
//                    second pass's sum may come as gathered partials
//   df_basis_change  out[i] = sum_j Q[j, i] * V[j], j in order, i < rows
//   stencil5_df      the Dirichlet 5-point stencil on a double-word vector
//   df_rank_sum      sum[i] = the double-word sum over the ranks of a
//                    row-sharded solve of their partials [r, i]; optionally
//                    acc[i] <- acc[i] + sum[i]
//
// None replaces a Pallas kernel: the JAX package runs this work as XLA
// loops (arnoldimethod_tpu/ops/df32.py df_sum, df_axpy_update_df;
// ops/df_expansion.py _df_dgks, _df_normalize, _df_basis_change_impl;
// models/operators.py Stencil5Operator.matvec_df; sharded, the collectives
// GSPMD makes of df_sum's tree).  Each kernel computes
// exactly the products and sums of the plain PyTorch version in
// arnoldimethod_torch/ops/df32.py and ops/df.py, in the same order, so its
// result is bitwise equal to it.
//
// Rounding.  The error-free transforms need every product and sum rounded
// on its own: an FMA contraction of `a * b - p` would skip a rounding and
// break them.  Every step is written with the explicitly rounded
// intrinsics (__fadd_rn, __fsub_rn, __fmul_rn and the double forms), which
// nvcc never contracts, and the file is also built with -fmad=false.
// Dekker's split (2^12 + 1 for float, 2^27 + 1 for double) keeps two_prod
// free of FMA altogether, as the plain version is.
//
// Bound.  Each add or multiply is one lane-instruction (no FMA): the card
// issues 132 x 128 of them a clock in float32 (~33 T/s at 1,980 MHz) and
// 132 x 64 in float64.  A double-word multiply-add is 35 of them, 27 when
// both operands were split beforehand.  df_project, df_axpy, df_normalize
// and stencil5_df touch each word a few times and are bound by memory;
// df_basis_change uses each V word for every output row (27 x rows
// operations for 2 words) and is bound by operations.  Tensor cores
// cannot carry the compensation bit for bit (their products and sums are
// not the rounded steps of df_mul and df_add), so no kernel uses them.
// Design:
//   - df_project reproduces the tree of df32.df_sum: pad a row to N = 2^k,
//     combine the lower half (left operand) with the upper, repeatedly.
//     That tree reduces the bits of the index i from the top down, so any
//     grouping that reduces them in that order makes the same combines.
//     One launch; the plan (ops/df.py project_plan) splits i, top to
//     bottom, into [h: L bits | wt | b | c], with C = 2^|c| elements a run
//     of 32 or 128 bytes, T = (wt, c) threads a block and G = 2^|b| blocks
//     a row group:
//       1. thread (wt, c) of block b loads its 2^L elements h (a warp reads
//          whole runs; pad positions are (0, 0)), all loads first, and runs
//          their halving tree in registers (L is a template parameter, the
//          tree a template recursion: no local memory);
//       2. the block runs the halving tree over its T values down to C,
//          in shared memory, the levels with half < 32 by warp shuffles;
//       3. the block writes its C partials; the last block of the row to
//          arrive (a fence and an atomic counter a row) runs the halving
//          tree over the row's G * C partials (where they outgrow the
//          shared stage, their top levels folded in registers, up to 8
//          float or 4 double pairs a thread, loads first) and resets the
//          counter (so CUDA-graph replays start from zero).  With G = 1
//          the block finishes the row itself.
//     A block takes one row: blocks of two rows sharing their w loads
//     measured no faster on an H100 (w's re-reads come from L2).  Rows
//     past `rows` are zero and, with acc, still go through acc + 0, by
//     block (0, 0).
//   - df_axpy (plan: ops/df.py axpy_plan): each element keeps its rows j
//     in order (df_mul(h_j, V[j, i]), then df_add(w, -t): JAX's scan), so
//     the only parallelism is over the n elements and bytes in flight set
//     the rate.  A thread owns 2^L elements laid out as df_project's split
//     [h | wt | b | c] (so the fused norm can run df_project's tree; the
//     plain form takes runs of a whole block, C = T); h_j is split once a
//     block into a shared record (h, l, hi, lo) read as a broadcast; a
//     thread loads U rows of its elements (both words) into registers, all
//     loads first, then sums them.  A ring of shared stages filled by
//     cp.async measured slower in every case on an H100 (PERF.md §6).
//     With NORM the result's squares (df_mul(out, out), pads (0, 0)) go
//     through df_project's steps 1-3 (finish_row, its scratch), so the
//     norm of a Gram-Schmidt pass costs no second launch and no second
//     read of w.
//   - df_normalize: every block recomputes the step's scalars from the six
//     words of the three sums on the card (df32.df_sqrt and df_inv, IEEE
//     divides and square roots, no contraction), so the decisions need no
//     host read and no second launch; then a grid-stride loop scales the
//     chosen pass's w, 16 bytes of each word a thread a step.  Block 0
//     also writes the H column and the flag.  On a breakdown the row is
//     left unscaled (finite for the steps that run on it until the host
//     reads the flags); the host finishes such a step and runs the steps
//     after it again (ops/df_expansion.py).
//   - df_basis_change (plan: ops/df.py basis_plan): only the first `rows`
//     outputs (a restart keeps rows 0..k; the expansion rewrites the
//     rest).  A register tile: a thread sums R rows by C columns over j in
//     order, R C independent chains (the plan's tile is 8 x 2 for float
//     words and 4 x 2 for double, the fastest of those instantiated on an
//     H100).  Q's entries
//     are split once a block, into shared memory as records (h, l, hi, lo)
//     that a warp reads as a broadcast; V's rows stream through two shared
//     stages by cp.async, J = 32 / R rows a stage, and a thread splits each
//     V hi word it loads once for its R rows.  Indices inside the loop are
//     32-bit.  A block sums at most 64 rows; with one row slab (rows <= 64)
//     the output may be V itself: a block owns its columns and reads all
//     their rows before it writes.
//   - stencil5_df (plan: ops/df.py stencil_plan): a tile of 32 columns by
//     4 P rows (P = 1, 2, 4 points a thread, as many as keep two blocks on
//     every SM) and its halo in shared memory, each x pair stored once with
//     its hi word's split; the coefficients' splits come from the host;
//     every load is issued before the arithmetic.  Missing neighbours are
//     (0, 0) and still go through the arithmetic.
//   - The sums over the ranks of a sharded solve (rank_fold).  Each rank
//     all-gathers every rank's partial pairs (parallel/comm.py), then folds
//     the same bits, so every rank gets the same sums and df_normalize's
//     decisions agree without a broadcast.  The order is df_sum's rule
//     along the rank axis (a local tree and then a rank tree differ from
//     one tree over the global index in low words; they agree at one
//     rank).  A group of min(P', 32) lanes a coefficient: lane q folds
//     ranks q, q + lanes, ... in registers (the top bits first), then the
//     group's shuffles halve the rest, as df_project's last levels do, so
//     up to 256 ranks need no local memory.  The work is P k pairs read and
//     P k adds: at a step's k <= maxdim + 2 a launch of its own costs more
//     than the work, so a Krylov step folds each sum in the prologue of the
//     kernel that consumes it: df_axpy's gathered form (every block folds
//     its rows' coefficients before it splits them; block 0 writes the
//     whole record for df_normalize) and df_normalize's step form (every
//     block folds s2).  df_rank_sum (ops/df.py) is the fold alone, a warp a
//     coefficient, for the sums outside a step.
// The C entries launch on the caller's stream, never synchronise, and
// return cudaGetLastError() (or a refusal code) so the wrapper can raise.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_(double a) { return __dsqrt_rn(a); }

template <typename T> struct Split;
template <> struct Split<float> { static constexpr float value = 4097.0f; };
template <> struct Split<double> { static constexpr double value = 134217729.0; };

template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = add_(a, b);
  const T bp = sub_(s, a);
  const T t1 = sub_(s, bp);
  e = add_(sub_(a, t1), sub_(b, bp));
}

template <typename T>
__device__ __forceinline__ void quick_two_sum(T a, T b, T& s, T& e) {
  s = add_(a, b);
  const T t = sub_(s, a);
  e = sub_(b, t);
}

// Dekker's split: a = hi + lo, each half of the significand (df32.split).
template <typename T>
__device__ __forceinline__ void split_(T a, T& hi, T& lo) {
  const T ac = mul_(Split<T>::value, a);
  const T ta = sub_(ac, a);
  hi = sub_(ac, ta);
  lo = sub_(a, hi);
}

// two_prod from operands split beforehand: the same operations on the
// same values as splitting them here, so a split can be made once and
// used for every product the operand enters.
template <typename T>
__device__ __forceinline__ void two_prod_split(T a, T ahi, T alo, T b, T bhi,
                                               T blo, T& p, T& e) {
  p = mul_(a, b);
  const T e1 = sub_(mul_(ahi, bhi), p);
  const T e2 = add_(e1, mul_(ahi, blo));
  const T e3 = add_(e2, mul_(alo, bhi));
  e = add_(e3, mul_(alo, blo));
}

template <typename T>
__device__ __forceinline__ void two_prod(T a, T b, T& p, T& e) {
  T ahi, alo, bhi, blo;
  split_(a, ahi, alo);
  split_(b, bhi, blo);
  two_prod_split(a, ahi, alo, b, bhi, blo, p, e);
}

// A double word (h, l) with its hi word's split (hi, lo): one record of
// 16 bytes (float) or 32 (double), read by one or two vector loads.
template <typename T>
struct alignas(4 * sizeof(T)) SplitWord {
  T h, l, hi, lo;
};

template <typename T>
__device__ __forceinline__ SplitWord<T> split_word(T h, T l) {
  SplitWord<T> s;
  s.h = h;
  s.l = l;
  split_(h, s.hi, s.lo);
  return s;
}

// (xh, xl) + (yh, yl): df32.df_add.
template <typename T>
__device__ __forceinline__ void df_add(T xh, T xl, T yh, T yl, T& zh, T& zl) {
  T sh, se;
  two_sum(xh, yh, sh, se);
  const T te = add_(add_(xl, yl), se);
  quick_two_sum(sh, te, zh, zl);
}

// (xh, xl) * (yh, yl): df32.df_mul.
template <typename T>
__device__ __forceinline__ void df_mul(T xh, T xl, T yh, T yl, T& zh, T& zl) {
  T ph, pe;
  two_prod(xh, yh, ph, pe);
  pe = add_(pe, add_(mul_(xh, yl), mul_(xl, yh)));
  quick_two_sum(ph, pe, zh, zl);
}

// (xh, xl) * c for a single word c: df32.df_scale.
template <typename T>
__device__ __forceinline__ void df_scale(T xh, T xl, T c, T& zh, T& zl) {
  T ph, pe;
  two_prod(xh, c, ph, pe);
  pe = add_(pe, mul_(xl, c));
  quick_two_sum(ph, pe, zh, zl);
}

// 1 / (xh, xl): df32.df_inv (a seed and one Newton step in double word).
template <typename T>
__device__ __forceinline__ void df_inv(T xh, T xl, T& zh, T& zl) {
  const T r = div_(T(1), xh);
  T ph, pe, dh, dl, ch, ce;
  df_mul(xh, xl, r, T(0), ph, pe);
  df_add(T(1), T(0), -ph, -pe, dh, dl);
  df_scale(dh, dl, r, ch, ce);
  df_add(r, T(0), ch, ce, zh, zl);
}

// The root of a non-negative (sh, sl): df32.df_sqrt; zero gives (0, 0).
template <typename T>
__device__ __forceinline__ void df_sqrt(T sh, T sl, T& zh, T& zl) {
  const T r = sqrt_(sh);
  T r2h, r2e, dh, dl;
  two_prod(r, r, r2h, r2e);
  df_add(sh, sl, -r2h, -r2e, dh, dl);
  const T corr = r > T(0) ? div_(add_(dh, dl), mul_(T(2), r)) : T(0);
  quick_two_sum(r, corr, zh, zl);
}

// -- df_project ------------------------------------------------------------

constexpr int kProjectThreads = 256;       // the most threads a block
constexpr size_t kProjectStage = 48 * 1024;  // shared memory a block

// The halving tree of df32.df_sum over the `len` pairs at (sh, sl)[t], down
// to `keep` pairs (powers of two): levels with half >= 32 in shared
// memory, a barrier each; the rest in warp 0 by shuffles.  The lower index
// is the left operand.  Every thread of the block calls it; the result is
// at (sh, sl)[t], t < keep, after its closing barrier.
template <typename T>
__device__ __forceinline__ void halve_shared(T* sh, T* sl, int len, int keep) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (; len > keep && len > 32; len /= 2) {
    const int half = len / 2;
    for (int t = tid; t < half; t += nt)
      df_add(sh[t], sl[t], sh[t + half], sl[t + half], sh[t], sl[t]);
    __syncthreads();
  }
  if (len > keep) {
    if (tid < 32) {
      const unsigned mask = nt >= 32 ? 0xffffffffu : (1u << nt) - 1u;
      T h = tid < len ? sh[tid] : T(0);
      T l = tid < len ? sl[tid] : T(0);
      for (int half = len / 2; half >= keep; half /= 2) {
        const T uh = __shfl_down_sync(mask, h, half);
        const T ul = __shfl_down_sync(mask, l, half);
        df_add(h, l, uh, ul, h, l);  // valid in lanes < half
      }
      if (tid < keep) {
        sh[tid] = h;
        sl[tid] = l;
      }
    }
    __syncthreads();
  }
}

// The halving tree of df32.df_sum over K pairs in registers: one level a
// template recursion, so every index is a compile-time constant.
template <int K, typename T>
__device__ __forceinline__ void halve_registers(T* h, T* l) {
  if constexpr (K > 1) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i)
      df_add(h[i], l[i], h[i + K / 2], l[i + K / 2], h[i], l[i]);
    halve_registers<K / 2>(h, l);
  }
}

// The same over the first q of K pairs (q a power of two, at most K): the
// levels with half < q, so every index stays a compile-time constant.
template <int K, typename T>
__device__ __forceinline__ void halve_registers_first(T* h, T* l, int q) {
  if constexpr (K > 1) {
    if (K / 2 < q) {
#pragma unroll
      for (int i = 0; i < K / 2; ++i)
        df_add(h[i], l[i], h[i + K / 2], l[i + K / 2], h[i], l[i]);
    }
    halve_registers_first<K / 2>(h, l, q);
  }
}

// Row `row`'s result (h, l) into (ch, cl); with acc, acc <- acc + c.
template <typename T>
__device__ __forceinline__ void project_out(int64_t row, T h, T l, T* ch,
                                            T* cl, T* acc_h, T* acc_l) {
  ch[row] = h;
  cl[row] = l;
  if (acc_h != nullptr) {
    T zh, zl;
    df_add(acc_h[row], acc_l[row], h, l, zh, zl);
    acc_h[row] = zh;
    acc_l[row] = zl;
  }
}

// The most partials of a row the last block folds a thread in registers:
// 8 float or 4 double pairs (16 registers).
template <typename T>
constexpr int kFoldPartials = 32 / sizeof(T);

// Steps 2 and 3 of row `row`'s sum over a grid of G = gridDim.x blocks a
// row: the T values (sh, sl)[tid], stored by every thread before a
// barrier, are halved down to C; with G = 1 the block finishes the row,
// else it writes its C partials to the row's M = G * C in (part_h,
// part_l) and the last block of the row to arrive sums them and resets
// the row's counter: while M > kFoldPartials * stage, halving levels in
// device memory; then, where M > stage, with M = Q * stage a thread loads
// the Q partials k stage + r of each of its r < stage (all loads first)
// and halves them in registers (the top bits, k, first); the block halves
// the M or stage values in shared memory.  sh and sl hold max(T, stage)
// pairs each.
// Returns true in the one thread that holds the row's sum (h, l).
template <typename T>
__device__ __forceinline__ bool finish_row(T* sh, T* sl, int C, int stage,
                                           int64_t row, T* __restrict__ part_h,
                                           T* __restrict__ part_l,
                                           unsigned* __restrict__ arrivals,
                                           T& h, T& l) {
  __shared__ bool last;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t G = gridDim.x, b = blockIdx.x;
  halve_shared(sh, sl, nt, C);
  if (G == 1) {  // the block holds the whole row: finish here
    halve_shared(sh, sl, C, 1);
    h = sh[0];
    l = sl[0];
    return tid == 0;
  }
  const int64_t M = G * C;
  T* rh = part_h + row * M;
  T* rl = part_l + row * M;
  if (tid < C) {
    __stcg(rh + b * C + tid, sh[tid]);
    __stcg(rl + b * C + tid, sl[tid]);
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrivals + row, 1u) == unsigned(G - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  int64_t len = M;
  constexpr int F = kFoldPartials<T>;
  for (; len > int64_t(F) * stage; len /= 2) {  // device memory
    const int64_t half = len / 2;
    for (int64_t t = tid; t < half; t += nt) {
      T zh, zl;
      df_add(__ldcg(rh + t), __ldcg(rl + t), __ldcg(rh + t + half),
             __ldcg(rl + t + half), zh, zl);
      __stcg(rh + t, zh);
      __stcg(rl + t, zl);
    }
    __syncthreads();
  }
  if (len <= stage) {
    for (int t = tid; t < len; t += nt) {
      sh[t] = __ldcg(rh + t);
      sl[t] = __ldcg(rl + t);
    }
  } else {  // Q = len / stage partials a thread for each r < stage
    int Q = 1;
    while (int64_t(Q) * stage < len) Q *= 2;
    for (int r = tid; r < stage; r += nt) {
      T vh[F], vl[F];
#pragma unroll
      for (int k = 0; k < F; ++k) {
        vh[k] = k < Q ? __ldcg(rh + r + k * stage) : T(0);
        vl[k] = k < Q ? __ldcg(rl + r + k * stage) : T(0);
      }
      halve_registers_first<F>(vh, vl, Q);
      sh[r] = vh[0];
      sl[r] = vl[0];
    }
    len = stage;
  }
  __syncthreads();
  halve_shared(sh, sl, int(len), 1);
  if (tid != 0) return false;
  arrivals[row] = 0u;
  h = sh[0];
  l = sl[0];
  return true;
}

// One launch of df_project: grid (G, rows), T threads; see the design
// above.  `stage` is the most partials of its row the last block holds in
// shared memory; the scratch (part_h, part_l) holds rows * G * C pairs and
// `arrivals` one counter a row, zero between launches.
template <typename T, int L>
__global__ void __launch_bounds__(kProjectThreads)
project_kernel(const T* __restrict__ Vh, const T* __restrict__ Vl, int64_t ld,
               const T* __restrict__ wh, const T* __restrict__ wl, int64_t n,
               int64_t rows, int64_t m1, int C, int stage,
               T* __restrict__ part_h, T* __restrict__ part_l,
               unsigned* __restrict__ arrivals, T* __restrict__ ch,
               T* __restrict__ cl, T* acc_h, T* acc_l) {
  constexpr int S = 1 << L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t G = gridDim.x, b = blockIdx.x, row = blockIdx.y;

  if (b == 0 && row == 0) {
    for (int64_t r = rows + tid; r < m1; r += nt)
      project_out(r, T(0), T(0), ch, cl, acc_h, acc_l);
  }
  if (rows == 0) return;  // uniform across the launch

  // 1. The halving tree over the thread's elements i = base + h * step,
  //    all loads issued first.
  const int64_t base = int64_t(tid / C) * G * C + b * C + tid % C;
  const int64_t step = int64_t(nt) * G;
  T ph[S], pl[S];
  {
    T w_h[S], w_l[S];
#pragma unroll
    for (int h = 0; h < S; ++h) {
      const int64_t i = base + h * step;
      w_h[h] = i < n ? __ldg(wh + i) : T(0);
      w_l[h] = i < n ? __ldg(wl + i) : T(0);
      ph[h] = i < n ? __ldg(Vh + row * ld + i) : T(0);
      pl[h] = i < n ? __ldg(Vl + row * ld + i) : T(0);
    }
#pragma unroll
    for (int h = 0; h < S; ++h) {
      if (base + h * step < n)
        df_mul(ph[h], pl[h], w_h[h], w_l[h], ph[h], pl[h]);
    }
    halve_registers<S>(ph, pl);
  }

  // 2-3. The block's tree over its T values, then the row's partials.
  T* sh = reinterpret_cast<T*>(smem_raw);
  T* sl = sh + (nt > stage ? nt : stage);
  sh[tid] = ph[0];
  sl[tid] = pl[0];
  __syncthreads();
  T h, l;
  if (finish_row(sh, sl, C, stage, row, part_h, part_l, arrivals, h, l))
    project_out(row, h, l, ch, cl, acc_h, acc_l);
}

// The largest fold instantiated: 2^L element pairs of V a thread.
constexpr int kMaxFold = 4;

template <typename T>
int project(const void* Vh, const void* Vl, int64_t ld, const void* wh,
            const void* wl, int64_t n, int64_t rows, int64_t m1,
            int64_t threads, int64_t C, int64_t G, int64_t L, int64_t stage,
            void* part, int64_t part_words, void* arrivals,
            int64_t arrival_slots, void* ch, void* cl, void* acc_h,
            void* acc_l, void* stream) {
  auto pow2 = [](int64_t x) { return x >= 1 && (x & (x - 1)) == 0; };
  int64_t N = 1;
  while (N < n) N *= 2;
  const int64_t span = threads > stage ? threads : stage;
  if (n < 1 || ld < n || rows < 0 || rows > m1 || !pow2(threads)
      || threads > kProjectThreads || !pow2(C) || C > threads || L < 0
      || L > kMaxFold || G < 1 || (threads << L) * G != N || !pow2(stage)
      || size_t(2 * span) * sizeof(T) > kProjectStage
      || rows * G * C * 2 > part_words || rows > arrival_slots)
    return int(cudaErrorInvalidValue);
  if (rows > 65535 || G > INT32_MAX) return int(cudaErrorInvalidConfiguration);
  const dim3 grid(rows > 0 ? unsigned(G) : 1u, rows > 0 ? unsigned(rows) : 1u);
  const size_t smem = size_t(2 * span) * sizeof(T);
  auto s = static_cast<cudaStream_t>(stream);
  T* ph = static_cast<T*>(part);
  T* pl = ph + rows * G * C;
#define DF_PROJECT_CASE(LL)                                                    \
  if (L == LL) {                                                               \
    project_kernel<T, LL><<<grid, unsigned(threads), smem, s>>>(               \
        static_cast<const T*>(Vh), static_cast<const T*>(Vl), ld,              \
        static_cast<const T*>(wh), static_cast<const T*>(wl), n, rows, m1,     \
        int(C), int(stage), ph, pl, static_cast<unsigned*>(arrivals),          \
        static_cast<T*>(ch), static_cast<T*>(cl), static_cast<T*>(acc_h),      \
        static_cast<T*>(acc_l));                                               \
    return int(cudaGetLastError());                                            \
  }
  DF_PROJECT_CASE(0) DF_PROJECT_CASE(1) DF_PROJECT_CASE(2) DF_PROJECT_CASE(3)
  DF_PROJECT_CASE(4)
#undef DF_PROJECT_CASE
  return int(cudaErrorInvalidValue);
}

// -- df_basis_change -------------------------------------------------------

// cp.async: a copy from device memory to shared memory that the thread
// does not wait on; src_bytes below the copy's size zero-fills the rest.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_word(void* dst, const void* src,
                                              int src_bytes) {
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// (th, tl) = df_mul(q, v) from both operands' splits: 20 operations.
template <typename T>
__device__ __forceinline__ void mul_split(const SplitWord<T>& q, T vh, T vl,
                                          T vhi, T vlo, T& th, T& tl) {
  T p, e;
  two_prod_split(q.h, q.hi, q.lo, vh, vhi, vlo, p, e);
  e = add_(e, add_(mul_(q.h, vl), mul_(q.l, vh)));
  quick_two_sum(p, e, th, tl);
}

// The tile a thread sums is R rows by C columns (template parameters; the
// plan picks them).  A stage holds J = 32 / R rows j, so that a block of W
// warps has J * W R Q records a stage: one a thread.  A block sums at most
// kBasisSlabRows rows: W <= kBasisSlabRows / R, and the launch bound lets
// a thread of a tile of 8 or 16 rows use up to 255 registers.
constexpr int kBasisSlabRows = 64;
// Rows of Q indexed in 32 bits: j * m1 + i < 2^31.
constexpr int64_t kBasisMaxRows = 46340;

// C values of one word: one vector load.
template <typename T, int C>
struct alignas(C * sizeof(T)) Cols {
  T v[C];
};

// acc <- df_add(acc, df_mul(Q[j, i], V[j, col])) from both operands'
// splits: 27 operations.
template <typename T>
__device__ __forceinline__ void basis_madd(const SplitWord<T>& q, T vh, T vl,
                                           T vhi, T vlo, T& ah, T& al) {
  T th, tl;
  mul_split(q, vh, vl, vhi, vlo, th, tl);
  df_add(ah, al, th, tl, ah, al);
}

// One row j of a stage into the thread's R x C accumulators: V's C
// columns of both words in two vector loads, their hi words split once;
// Q's record of each of the R rows (a broadcast across the warp).
template <typename T, int R, int C>
__device__ __forceinline__ void basis_step(const SplitWord<T>* q,
                                           const T* v, int jj, int RP,
                                           int row, int lane, T (&ah)[R][C],
                                           T (&al)[R][C]) {
  constexpr int TC = 32 * C;
  const Cols<T, C> vh =
      *reinterpret_cast<const Cols<T, C>*>(v + jj * 2 * TC + lane * C);
  const Cols<T, C> vl =
      *reinterpret_cast<const Cols<T, C>*>(v + (jj * 2 + 1) * TC + lane * C);
  T vhi[C], vlo[C];
#pragma unroll
  for (int c = 0; c < C; ++c) split_(vh.v[c], vhi[c], vlo[c]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const SplitWord<T> qq = q[jj * RP + row + r];
#pragma unroll
    for (int c = 0; c < C; ++c)
      basis_madd(qq, vh.v[c], vl.v[c], vhi[c], vlo[c], ah[r][c], al[r][c]);
  }
}

// Grid (column tiles of TC = 32 C, row slabs of W R); a block W warps.
// Warp w accumulates rows i0 + w R .. + R - 1, lane g the columns
// c0 + g C .. + C - 1, over j in order (a stage: J = 32 / R rows j).  Two stages in shared memory, each
// holding J rows j: Q's split records sq[jj][r] (r < W R, the slab's rows,
// zero past `rows`) and V's words sv[jj][word][TC] (zero past n).  While
// a stage is summed, cp.async fills V's next rows into the other stage and
// the thread holds its next Q entry in registers, to split and store after.
// V and out may be the same storage when the grid has one slab: a block
// reads all the rows of its columns before it writes any.
template <typename T, int R, int C>
__global__ void __launch_bounds__(32 * kBasisSlabRows / R)
basis_kernel(const T* Vh, const T* Vl, const T* __restrict__ Qh,
             const T* __restrict__ Ql, int m1, int64_t n, int rows, bool vec,
             T* outh, T* outl) {
  constexpr int J = 32 / R, TC = 32 * C;
  constexpr int E = 16 / sizeof(T);    // words of a 16-byte copy
  constexpr int U = TC / E;            // 16-byte copies a row of a word
  static_assert(J * R == 32 && TC % E == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int RP = (blockDim.x / 32) * R;
  const int64_t c0 = int64_t(blockIdx.x) * TC;
  const int i0 = blockIdx.y * RP;
  SplitWord<T>* sq = reinterpret_cast<SplitWord<T>*>(smem_raw);
  T* sv = reinterpret_cast<T*>(sq + 2 * J * RP);

  // This thread's Q record of a stage: row j = chunk J + tid / RP, column
  // i = i0 + tid % RP.
  const int qi = i0 + tid % RP;
  const bool q_in = qi < rows;
  auto load_q = [&](int chunk, T& h, T& l) {
    const int j = chunk * J + tid / RP;
    const bool ok = q_in && j < m1;
    h = ok ? __ldg(Qh + j * m1 + qi) : T(0);
    l = ok ? __ldg(Ql + j * m1 + qi) : T(0);
  };
  auto issue_v = [&](int chunk, int stage) {
    T* dst = sv + stage * J * 2 * TC;
    const int j0 = chunk * J;
    if (vec) {
      for (int u = tid; u < J * 2 * U; u += blockDim.x) {
        const int g = u % U, word = (u / U) % 2, jj = u / (2 * U);
        const int64_t col = c0 + g * E;
        const bool ok = j0 + jj < m1 && col < n;
        const T* src =
            (word ? Vl : Vh) + (ok ? int64_t(j0 + jj) * n + col : 0);
        cp_async_16(dst + (jj * 2 + word) * TC + g * E, src, ok ? 16 : 0);
      }
    } else {
      for (int u = tid; u < J * 2 * TC; u += blockDim.x) {
        const int g = u % TC, word = (u / TC) % 2, jj = u / (2 * TC);
        const int64_t col = c0 + g;
        const bool ok = j0 + jj < m1 && col < n;
        const T* src =
            (word ? Vl : Vh) + (ok ? int64_t(j0 + jj) * n + col : 0);
        cp_async_word<int(sizeof(T))>(dst + (jj * 2 + word) * TC + g, src,
                                      ok ? int(sizeof(T)) : 0);
      }
    }
    cp_async_commit();
  };

  T ah[R][C], al[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) ah[r][c] = al[r][c] = T(0);
  }
  const int chunks = (m1 + J - 1) / J;
  {
    T h, l;
    load_q(0, h, l);
    issue_v(0, 0);
    sq[tid] = split_word(h, l);
  }
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int stage = chunk & 1;
    const bool more = chunk + 1 < chunks;
    T nh = T(0), nl = T(0);
    if (more) load_q(chunk + 1, nh, nl);
    cp_async_wait_all();
    __syncthreads();  // the stage is in; every thread is done with the other
    if (more) issue_v(chunk + 1, stage ^ 1);
    const SplitWord<T>* q = sq + stage * J * RP;
    const T* v = sv + stage * J * 2 * TC;
    const int jn = m1 - chunk * J;
    if (jn >= J) {
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        basis_step<T, R, C>(q, v, jj, RP, warp * R, lane, ah, al);
    } else {
      for (int jj = 0; jj < jn; ++jj)
        basis_step<T, R, C>(q, v, jj, RP, warp * R, lane, ah, al);
    }
    if (more) sq[(stage ^ 1) * J * RP + tid] = split_word(nh, nl);
  }

  const int64_t col = c0 + lane * C;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + warp * R + r;
    if (i < rows) {
      T* oh = outh + int64_t(i) * n + col;
      T* ol = outl + int64_t(i) * n + col;
      if (vec) {
        if (col < n) {
          Cols<T, C> h, l;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            h.v[c] = ah[r][c];
            l.v[c] = al[r][c];
          }
          *reinterpret_cast<Cols<T, C>*>(oh) = h;
          *reinterpret_cast<Cols<T, C>*>(ol) = l;
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (col + c < n) {
            oh[c] = ah[r][c];
            ol[c] = al[r][c];
          }
        }
      }
    }
  }
}

template <typename T, int R, int C>
int basis_launch(const void* Vh, const void* Vl, const void* Qh,
                 const void* Ql, int64_t m1, int64_t n, int64_t rows,
                 int64_t warps, void* outh, void* outl, void* stream) {
  constexpr int J = 32 / R, TC = 32 * C, E = 16 / sizeof(T);
  const int64_t groups = (rows + R - 1) / R;
  const int64_t slabs = (groups + warps - 1) / warps;
  const int64_t blocks = (n + TC - 1) / TC;
  if (slabs > 65535 || blocks > INT32_MAX)
    return int(cudaErrorInvalidConfiguration);
  const size_t stage = size_t(J) * warps * R * sizeof(SplitWord<T>)
                       + size_t(J) * 2 * TC * sizeof(T);
  const size_t smem = 2 * stage;
  if (smem > 48 * 1024) return int(cudaErrorInvalidValue);  // no attribute
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = n % E == 0 && aligned(Vh) && aligned(Vl)
                   && aligned(outh) && aligned(outl);
  basis_kernel<T, R, C><<<dim3(unsigned(blocks), unsigned(slabs)),
                          unsigned(32 * warps), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Vh), static_cast<const T*>(Vl),
      static_cast<const T*>(Qh), static_cast<const T*>(Ql), int(m1), n,
      int(rows), vec, static_cast<T*>(outh), static_cast<T*>(outl));
  return int(cudaGetLastError());
}

// The tiles instantiated, by word (ops/df.py _BASIS_TILES, the plan's
// first; --df-sweep measures the others against it).
template <typename T>
int basis_change(const void* Vh, const void* Vl, const void* Qh,
                 const void* Ql, int64_t m1, int64_t n, int64_t rows,
                 int64_t R, int64_t C, int64_t warps, void* outh, void* outl,
                 void* stream) {
  if (m1 < 1 || m1 > kBasisMaxRows || n < 1 || rows < 1 || rows > m1
      || warps < 1 || warps * R > kBasisSlabRows)
    return int(cudaErrorInvalidValue);
#define DF_BASIS_CASE(RR, CC)                                                  \
  if (R == RR && C == CC)                                                      \
    return basis_launch<T, RR, CC>(Vh, Vl, Qh, Ql, m1, n, rows, warps, outh,   \
                                   outl, stream);
  if constexpr (sizeof(T) == 4) {
    DF_BASIS_CASE(8, 2) DF_BASIS_CASE(16, 2) DF_BASIS_CASE(4, 4)
  } else {
    DF_BASIS_CASE(8, 2) DF_BASIS_CASE(4, 2)
  }
#undef DF_BASIS_CASE
  return int(cudaErrorInvalidValue);
}

// -- the sum over the ranks ------------------------------------------------

constexpr int kRankFold = 8;      // the most ranks a lane folds in registers
constexpr int64_t kMaxRanks = 32 * kRankFold;

// A row-sharded solve's gathered partials of one sum (parallel/comm.py):
// rank r's pair of coefficient i at (hi, lo)[r ld + i], `ranks` ranks
// (0: no such record), folded by `lanes` lanes, `fold` ranks a lane
// (rank_plan).
template <typename T>
struct Gathered {
  const T* hi;
  const T* lo;
  int64_t ld;
  int ranks, lanes, fold;
};

// rank_fold's shape for P ranks in blocks of `threads`: P' = P padded to a
// power of two, lanes = min(P', 32, threads) a coefficient, fold = P' /
// lanes ranks a lane.  False where P is out of range or a lane would fold
// more than kRankFold (only in blocks of fewer than 32 threads).
bool rank_plan(int64_t P, int64_t threads, int& lanes, int& fold) {
  if (P < 1 || P > kMaxRanks || threads < 1) return false;
  int64_t width = 1;
  while (width < P) width *= 2;
  int64_t w = width < 32 ? width : 32;
  if (w > threads) w = threads;
  lanes = int(w);
  fold = int(width / w);
  return fold <= kRankFold;
}

// The sum of a lane's ranks t lanes + q, t < fold, by df32.df_sum's tree
// over t (pairs t, t + fold/2, repeatedly), as the depth-first recursion
// S(b, s) = S(b, 2s) + S(b + s, 2s) down to the leaves s = fold, slot b:
// the same combines as halving the fold values level by level, with at most
// log2(kRankFold) + 1 pairs live.  `fold` is a power of two at most
// kRankFold; every index is a compile-time constant.
template <int B, int S, typename T>
__device__ __forceinline__ void fold_slots(const Gathered<T>& g, int64_t at,
                                           int64_t stride, int q, bool active,
                                           T& h, T& l) {
  if (S >= kRankFold || S >= g.fold) {
    const bool ok = active && B * g.lanes + q < g.ranks;
    h = ok ? __ldg(g.hi + at + B * stride) : T(0);
    l = ok ? __ldg(g.lo + at + B * stride) : T(0);
  } else if constexpr (S < kRankFold) {
    T bh, bl;
    fold_slots<B, 2 * S>(g, at, stride, q, active, h, l);
    fold_slots<B + S, 2 * S>(g, at, stride, q, active, bh, bl);
    df_add(h, l, bh, bl, h, l);
  }
}

// Coefficient i summed over the ranks' partials by df32.df_sum's tree
// along the rank axis: P padded with (0, 0) pairs to P' = 2^p, rank r
// paired with r + P'/2, repeatedly.  A group of g.lanes consecutive lanes
// of a warp takes a coefficient: lane q of the group sums its ranks
// t lanes + q, t < fold, in registers (the top bits, t, first:
// fold_slots); then the group halves its lanes by shuffles, the lower lane
// the left operand.  Which lanes split the tree changes no combine, so
// every (lanes, fold) gives the same bits.  Every lane of the warp calls it
// (the shuffles); a lane whose group has no coefficient passes active =
// false (zeros).  The sum is in the group's first lane.
template <typename T>
__device__ __forceinline__ void rank_fold(const Gathered<T>& g, int64_t i,
                                          bool active, T& vh, T& vl) {
  const int q = int(threadIdx.x) % g.lanes;
  fold_slots<0, 1>(g, int64_t(q) * g.ld + i, int64_t(g.lanes) * g.ld, q,
                   active, vh, vl);
  const unsigned mask = blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
  for (int half = g.lanes / 2; half >= 1; half /= 2) {
    const T uh = __shfl_down_sync(mask, vh, half);
    const T ul = __shfl_down_sync(mask, vl, half);
    df_add(vh, vl, uh, ul, vh, vl);  // valid in lanes q < half
  }
}

// -- df_axpy ---------------------------------------------------------------

constexpr int kAxpyThreads = 256;   // the most threads a block
constexpr int kAxpyMaxRows = 256;   // rows of V a launch (h records staged)
constexpr int kAxpyShared = 48 * 1024;  // shared memory a block

// w <- w - h_j V[j] for one row j and one element (df_mul(h_j, V[j, i]),
// then df_add(w, -t)), from h_j's split record and V's hi word split here.
template <typename T>
__device__ __forceinline__ void axpy_step(const SplitWord<T>& q, T vh, T vl,
                                          T& ah, T& al) {
  T vhi, vlo, th, tl;
  split_(vh, vhi, vlo);
  mul_split(q, vh, vl, vhi, vlo, th, tl);
  df_add(ah, al, -th, -tl, ah, al);
}

// One launch of df_axpy over rows j < rows (at most kAxpyMaxRows): grid G
// blocks of T threads; thread tid = (wt, c) of block b owns the K = 2^L
// elements i = base + h * step of df_project's split [h | wt | b | c],
// N = K T G.  The h records of every row are split into shared memory
// first; then, U rows at a time, a thread loads the rows' words of its K
// elements into registers, all loads first, and sums them in order.  With
// NORM the block then halves the squares of its results as df_project's
// one row does (finish_row), the sum into sum[0], sum[1].
// GATHER, the gathered form: h_j is coefficient h_off + j of a gathered
// record of k coefficients; every block folds its rows' sums over the
// ranks (rank_fold) before it splits them, the same bits in every block,
// so no block waits on another; block 0 folds the whole record and writes
// it to (fold_h, fold_l) when they are given.  A template parameter, so
// that the other form's code (and its registers) is the fused form's.
template <typename T, int L, int U, bool NORM, bool GATHER>
__global__ void __launch_bounds__(kAxpyThreads)
axpy_kernel(const T* __restrict__ wh, const T* __restrict__ wl,
            const T* __restrict__ hh, const T* __restrict__ hl,
            const T* __restrict__ Vh, const T* __restrict__ Vl, int64_t n,
            int rows, int C, int stage, Gathered<T> g, int k, int h_off,
            T* __restrict__ fold_h, T* __restrict__ fold_l,
            T* __restrict__ part_h, T* __restrict__ part_l,
            unsigned* __restrict__ arrivals, T* __restrict__ outh,
            T* __restrict__ outl, T* __restrict__ sum) {
  constexpr int K = 1 << L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t G = gridDim.x;
  const int64_t base = int64_t(tid / C) * G * C + int64_t(blockIdx.x) * C + tid % C;
  const int64_t step = int64_t(nt) * G;
  SplitWord<T>* rec = reinterpret_cast<SplitWord<T>*>(smem_raw);

  // The gathered form folds first, before w's words are live: the fold's
  // registers and the main loop's then never overlap (no local memory),
  // and the loads of w still overlap the first rows of V.
  if constexpr (GATHER) {
    // nt / lanes coefficients a pass, one a group of lanes; the bounds are
    // the block's, so every warp runs every pass (the shuffles).
    const bool whole = blockIdx.x == 0 && fold_h != nullptr;
    const int first = whole ? 0 : h_off, last = whole ? k : h_off + rows;
    for (int c0 = first; c0 < last; c0 += nt / g.lanes) {
      const int c = c0 + tid / g.lanes;
      T vh, vl;
      rank_fold(g, c, c < last, vh, vl);
      if (tid % g.lanes == 0 && c < last) {
        if (c >= h_off && c < h_off + rows) rec[c - h_off] = split_word(vh, vl);
        if (whole) {
          fold_h[c] = vh;
          fold_l[c] = vl;
        }
      }
    }
  }
  T ah[K], al[K];
#pragma unroll
  for (int h = 0; h < K; ++h) {
    const int64_t i = base + h * step;
    ah[h] = i < n ? __ldg(wh + i) : T(0);
    al[h] = i < n ? __ldg(wl + i) : T(0);
  }
  if constexpr (!GATHER) {
    for (int t = tid; t < rows; t += nt)
      rec[t] = split_word(__ldg(hh + t), __ldg(hl + t));
  }
  __syncthreads();

  for (int j0 = 0; j0 < rows; j0 += U) {
    T vh[U][K], vl[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int h = 0; h < K; ++h) {
        const int64_t i = base + h * step;
        const bool ok = j0 + u < rows && i < n;
        const int64_t at = ok ? int64_t(j0 + u) * n + i : 0;
        vh[u][h] = ok ? __ldg(Vh + at) : T(0);
        vl[u][h] = ok ? __ldg(Vl + at) : T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < rows) {
        const SplitWord<T> q = rec[j0 + u];
#pragma unroll
        for (int h = 0; h < K; ++h) axpy_step(q, vh[u][h], vl[u][h], ah[h], al[h]);
      }
    }
  }

  auto store = [&] {
#pragma unroll
    for (int h = 0; h < K; ++h) {
      const int64_t i = base + h * step;
      if (i < n) {
        outh[i] = ah[h];
        outl[i] = al[h];
      }
    }
  };
  if constexpr (!NORM) {
    store();
  } else {
    // df32.df_sum(df_mul(out, out)): pads (0, 0), the tree of df_project.
    T ph[K], pl[K];
#pragma unroll
    for (int h = 0; h < K; ++h) {
      ph[h] = pl[h] = T(0);
      if (base + h * step < n) df_mul(ah[h], al[h], ah[h], al[h], ph[h], pl[h]);
    }
    halve_registers<K>(ph, pl);
    __syncthreads();  // the records are read: the sum takes their memory
    T* sh = reinterpret_cast<T*>(smem_raw);
    T* sl = sh + (nt > stage ? nt : stage);
    sh[tid] = ph[0];
    sl[tid] = pl[0];
    __syncthreads();
    // The result is stored after the block's partials are published: the
    // fence before the arrival then waits for them alone.
    T h, l;
    const bool holds = finish_row(sh, sl, C, stage, 0, part_h, part_l,
                                  arrivals, h, l);
    store();
    if (holds) {
      sum[0] = h;
      sum[1] = l;
    }
  }
}

// The (L, U) instantiated: 4 to 16 elements of each word a group, U K;
// each plain or fused, in its own form or gathered.
#define DF_AXPY_SHAPES(X)                                                      \
  X(0, 4) X(0, 8) X(0, 16) X(1, 2) X(1, 4) X(1, 8) X(2, 1) X(2, 2) X(2, 4)     \
  X(3, 1) X(3, 2)

template <typename T, bool NORM, bool GATHER>
int axpy_launch(int64_t L, int64_t U, unsigned G, unsigned threads,
                size_t smem, cudaStream_t s, const T* wh, const T* wl,
                const T* hh, const T* hl, const T* Vh, const T* Vl, int64_t n,
                int rows, int C, int stage, Gathered<T> g, int k, int h_off,
                T* fold_h, T* fold_l, T* ph, T* pl, unsigned* arrivals,
                T* outh, T* outl, T* sum) {
#define DF_AXPY_CASE(LL, UU)                                                   \
  if (L == LL && U == UU) {                                                    \
    axpy_kernel<T, LL, UU, NORM, GATHER><<<G, threads, smem, s>>>(             \
        wh, wl, hh, hl, Vh, Vl, n, rows, C, stage, g, k, h_off, fold_h,        \
        fold_l, ph, pl, arrivals, outh, outl, sum);                            \
    return int(cudaGetLastError());                                            \
  }
  DF_AXPY_SHAPES(DF_AXPY_CASE)
#undef DF_AXPY_CASE
  return int(cudaErrorInvalidValue);
}

// sum == nullptr: the plain form; else the fused norm, whose scratch
// (part: 2 G C words, arrivals: one counter, zero) is df_project's.
// ranks == 0: h is (hh, hl)[j]; else the gathered form: (hh, hl) rank 0's
// hi and lo words of a gathered record of k coefficients, rank r's at
// r ld further, h_j its coefficient h_off + j; the record folded into
// (fold_h, fold_l), k words each, where they are given.
template <typename T>
int axpy(const void* wh, const void* wl, const void* hh, const void* hl,
         const void* Vh, const void* Vl, int64_t n, int64_t rows,
         int64_t threads, int64_t C, int64_t G, int64_t L, int64_t U,
         int64_t stage, int64_t ld, int64_t ranks, int64_t k, int64_t h_off,
         void* fold_h, void* fold_l, void* part, int64_t part_words,
         void* arrivals, int64_t arrival_slots, void* outh, void* outl,
         void* sum, void* stream) {
  auto pow2 = [](int64_t x) { return x >= 1 && (x & (x - 1)) == 0; };
  int64_t N = 1;
  while (N < n) N *= 2;
  const bool norm = sum != nullptr;
  const int64_t span = threads > stage ? threads : stage;
  const int64_t records = rows * int64_t(sizeof(SplitWord<T>));
  const int64_t tail = norm ? 2 * span * int64_t(sizeof(T)) : 0;
  const int64_t smem = records > tail ? records : tail;
  if (n < 1 || rows < 0 || rows > kAxpyMaxRows || !pow2(threads)
      || threads > kAxpyThreads || !pow2(C) || C > threads || L < 0 || G < 1
      || (threads << L) * G != N || smem > kAxpyShared
      || (norm && (!pow2(stage) || stage > G * C || part_words < 2 * G * C
                   || arrival_slots < 1)))
    return int(cudaErrorInvalidValue);
  Gathered<T> g{static_cast<const T*>(hh), static_cast<const T*>(hl), ld,
                int(ranks), 1, 1};
  if (ranks != 0
      && (!rank_plan(ranks, threads, g.lanes, g.fold) || ld < 1 || k < 1
          || k > INT32_MAX || h_off < 0 || h_off + rows > k
          || (fold_h == nullptr) != (fold_l == nullptr)))
    return int(cudaErrorInvalidValue);
  if (G > INT32_MAX) return int(cudaErrorInvalidConfiguration);
  T* ph = static_cast<T*>(part);
  T* pl = norm ? ph + G * C : nullptr;
  auto go = [&](auto norm_tag, auto gather_tag) {
    return axpy_launch<T, decltype(norm_tag)::value,
                       decltype(gather_tag)::value>(
        L, U, unsigned(G), unsigned(threads), size_t(smem),
        static_cast<cudaStream_t>(stream), static_cast<const T*>(wh),
        static_cast<const T*>(wl), static_cast<const T*>(hh),
        static_cast<const T*>(hl), static_cast<const T*>(Vh),
        static_cast<const T*>(Vl), n, int(rows), int(C), int(stage), g,
        int(k), int(h_off), static_cast<T*>(fold_h), static_cast<T*>(fold_l),
        ph, pl, static_cast<unsigned*>(arrivals), static_cast<T*>(outh),
        static_cast<T*>(outl), static_cast<T*>(sum));
  };
  if (ranks != 0)
    return norm ? go(std::true_type{}, std::true_type{})
                : go(std::false_type{}, std::true_type{});
  return norm ? go(std::true_type{}, std::false_type{})
              : go(std::false_type{}, std::false_type{});
}

// -- df_normalize ----------------------------------------------------------

// ETA = sqrt(2)/2 (ops/df32.py), rounded to the word as the plain
// version rounds it.
template <typename T> struct Eta;
template <> struct Eta<float> { static constexpr float value = 0x1.6a09e6p-1f; };
template <> struct Eta<double> { static constexpr double value = 0x1.6a09e667f3bcdp-1; };

// df_normalize's operands.  The one-sum form has only w1, s1 and out (r2
// null); the step form has them all.  Each sum is a double word of two
// scalars on the card.
template <typename T>
struct NormalizeArgs {
  const T *w1h, *w1l, *s1h, *s1l;  // the first pass's w and its sum
  const T *w2h, *w2l, *s2h, *s2l;  // the second pass's w and its sum
  const T *r2h, *r2l;              // the matvec's sum of squares
  const T *h1h, *h1l, *ch, *cl;    // both passes' coefficients, m1 each
  T *Hh, *Hl, *flag;               // H's column j (stride ld) and flags[j]
  T *outh, *outl;                  // the new row
  int64_t n, m1, ld, row;          // row = j + 1, where the norm goes
};

// What the step decides, from the sums: the host version's branches of
// ops/df_expansion.py (_dgks, then `not nh <= eta * ref`) on the same
// words with the same operations, so a NaN keeps the row as it does there.
template <typename T>
struct Decision {
  bool second;  // w and h from the second pass
  bool keep;    // scale w (no breakdown)
  T nh, nl;     // ||w||
  T ih, il;     // 1 / ||w||
};

template <typename T>
__device__ __forceinline__ Decision<T> decide(const NormalizeArgs<T>& a) {
  Decision<T> d{false, true, T(0), T(0), T(0), T(0)};
  df_sqrt(*a.s1h, *a.s1l, d.nh, d.nl);
  if (a.r2h != nullptr) {
    T rnorm, rl, ref;
    df_sqrt(*a.r2h, *a.r2l, rnorm, rl);
    const T wn1 = d.nh;
    d.second = wn1 < mul_(Eta<T>::value, rnorm);
    if (d.second) {
      df_sqrt(*a.s2h, *a.s2l, d.nh, d.nl);
      ref = wn1;
    } else {
      ref = rnorm;
    }
    d.keep = !(d.nh <= mul_(Eta<T>::value, ref));
  }
  df_inv(d.nh, d.nl, d.ih, d.il);
  return d;
}

// Grid-stride over the row, 16 bytes of each word a thread a step where
// every operand is 16-byte aligned, the rest (and every element
// otherwise) one a step: out = w * (ih, il) (df32.df_mul), or w itself on
// a breakdown.  Block 0 also writes the H column (df_add(h1, c) after a
// second pass, df_project's acc order; the norm at row j + 1) and the
// flag (1 for a breakdown).  With s2.ranks > 0, s2 is a gathered record
// of one coefficient: every block's first warp folds it over the ranks
// (rank_fold) before the decision, the same bits in every block.
template <typename T>
__global__ void __launch_bounds__(256)
normalize_kernel(NormalizeArgs<T> a, Gathered<T> s2, bool vec) {
  constexpr int E = 16 / sizeof(T);
  __shared__ T folded[2];
  if (s2.ranks > 0) {
    if (threadIdx.x < 32) {
      T vh, vl;
      rank_fold(s2, 0, true, vh, vl);
      if (threadIdx.x == 0) {
        folded[0] = vh;
        folded[1] = vl;
      }
    }
    __syncthreads();
    a.s2h = folded;
    a.s2l = folded + 1;
  }
  const Decision<T> d = decide(a);
  if (blockIdx.x == 0 && a.Hh != nullptr) {
    for (int64_t i = threadIdx.x; i < a.m1; i += blockDim.x) {
      T zh = a.h1h[i], zl = a.h1l[i];
      if (d.second) df_add(zh, zl, a.ch[i], a.cl[i], zh, zl);
      if (i == a.row) {
        zh = d.nh;
        zl = d.nl;
      }
      a.Hh[i * a.ld] = zh;
      a.Hl[i * a.ld] = zl;
    }
    if (threadIdx.x == 0) *a.flag = d.keep ? T(0) : T(1);
  }
  const T* __restrict__ wh = d.second ? a.w2h : a.w1h;
  const T* __restrict__ wl = d.second ? a.w2l : a.w1l;
  T* __restrict__ outh = a.outh;
  T* __restrict__ outl = a.outl;
  const int64_t n = a.n;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nv = vec ? n / E : 0;
  for (int64_t v = first; v < nv; v += stride) {
    const Cols<T, E> h = reinterpret_cast<const Cols<T, E>*>(wh)[v];
    const Cols<T, E> l = reinterpret_cast<const Cols<T, E>*>(wl)[v];
    Cols<T, E> zh = h, zl = l;
    if (d.keep) {
#pragma unroll
      for (int c = 0; c < E; ++c)
        df_mul(h.v[c], l.v[c], d.ih, d.il, zh.v[c], zl.v[c]);
    }
    reinterpret_cast<Cols<T, E>*>(outh)[v] = zh;
    reinterpret_cast<Cols<T, E>*>(outl)[v] = zl;
  }
  for (int64_t i = nv * E + first; i < n; i += stride) {
    T zh = wh[i], zl = wl[i];
    if (d.keep) df_mul(wh[i], wl[i], d.ih, d.il, zh, zl);
    outh[i] = zh;
    outl[i] = zl;
  }
}

// s2_ranks == 0: s2 is a pair of words; else (s2h, s2l) are rank 0's hi
// and lo words of a gathered record of one coefficient, rank r's at
// r s2_ld further (the step form only).
template <typename T>
int normalize(NormalizeArgs<T> a, int64_t s2_ld, int64_t s2_ranks,
              void* stream) {
  const bool step = a.r2h != nullptr;
  Gathered<T> s2{a.s2h, a.s2l, s2_ld, int(s2_ranks), 1, 1};
  if (a.n < 1 || a.w1h == nullptr || a.s1h == nullptr || a.outh == nullptr
      || (step && (a.w2h == nullptr || a.s2h == nullptr || a.h1h == nullptr
                   || a.ch == nullptr || a.Hh == nullptr || a.flag == nullptr
                   || a.m1 < 1 || a.ld < 1 || a.row < 1 || a.row >= a.m1))
      || (s2_ranks != 0 && (!step || s2_ld < 1
                            || !rank_plan(s2_ranks, 32, s2.lanes, s2.fold))))
    return int(cudaErrorInvalidValue);
  if (!step) a.Hh = nullptr;
  constexpr int E = 16 / sizeof(T);
  auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = aligned(a.w1h) && aligned(a.w1l) && aligned(a.w2h)
                   && aligned(a.w2l) && aligned(a.outh) && aligned(a.outl);
  const int64_t blocks = ((vec ? (a.n + E - 1) / E : a.n) + 255) / 256;
  const unsigned grid = unsigned(blocks < 132 * 16 ? blocks : 132 * 16);
  normalize_kernel<T><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, s2, vec);
  return int(cudaGetLastError());
}

// -- df_rank_sum -----------------------------------------------------------

constexpr int kRankSumWarps = 4;  // a block: 4 warps, a coefficient each

// Coefficient i < k summed over the ranks (rank_fold, a warp a
// coefficient: lanes = min(P', 32)).  Lane 0 writes the sum and, with acc,
// acc <- acc + sum (df_project's order).
template <typename T>
__global__ void __launch_bounds__(32 * kRankSumWarps)
rank_sum_kernel(Gathered<T> g, int k, T* __restrict__ outh,
                T* __restrict__ outl, T* acc_h, T* acc_l) {
  const int i = blockIdx.x * kRankSumWarps + threadIdx.x / 32;
  if (i >= k) return;  // the whole warp: i is the warp's
  T vh, vl;
  rank_fold(g, i, true, vh, vl);
  if (threadIdx.x % 32 == 0) project_out(i, vh, vl, outh, outl, acc_h, acc_l);
}

template <typename T>
int rank_sum(const void* hi, const void* lo, int64_t ld, int64_t P,
             int64_t k, void* outh, void* outl, void* acc_h, void* acc_l,
             void* stream) {
  Gathered<T> g{static_cast<const T*>(hi), static_cast<const T*>(lo), ld,
                int(P), 1, 1};
  if (!rank_plan(P, 32, g.lanes, g.fold) || k < 1 || k > INT32_MAX || ld < 1
      || hi == nullptr || lo == nullptr || outh == nullptr || outl == nullptr
      || (acc_h == nullptr) != (acc_l == nullptr))
    return int(cudaErrorInvalidValue);
  const unsigned blocks = unsigned((k + kRankSumWarps - 1) / kRankSumWarps);
  rank_sum_kernel<T><<<blocks, 32 * kRankSumWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      g, int(k), static_cast<T*>(outh), static_cast<T*>(outl),
      static_cast<T*>(acc_h), static_cast<T*>(acc_l));
  return int(cudaGetLastError());
}

// -- stencil5_df -----------------------------------------------------------

constexpr int kStencilWarps = 4;  // a block: 4 warps, a tile 32 columns wide

// The five coefficients (center, west, east, north, south) in the word
// type, with their splits made on the host (df32.split, the same values).
template <typename T>
struct Coeffs {
  T v[5], hi[5], lo[5];
};

// (zh, zl) = df_scale(x, coefficient t) from both operands' splits.
template <typename T>
__device__ __forceinline__ void scale_split(const SplitWord<T>& x,
                                            const Coeffs<T>& k, int t, T& zh,
                                            T& zl) {
  T p, e;
  two_prod_split(x.h, x.hi, x.lo, k.v[t], k.hi[t], k.lo[t], p, e);
  e = add_(e, mul_(x.l, k.v[t]));
  quick_two_sum(p, e, zh, zl);
}

// Two words of a shared record: a vector load of 8 (float) or 16 bytes.
template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T a, b;
};

// The split record e from the pair array sp and the split array ss.
template <typename T>
__device__ __forceinline__ SplitWord<T> record(const Pair<T>* sp,
                                               const Pair<T>* ss, int e) {
  const Pair<T> v = sp[e], h = ss[e];
  return SplitWord<T>{v.a, v.b, h.a, h.b};
}

// A tile of 32 columns by 4 P rows, one column and P rows a thread.  The
// tile and its one-point halo (zero outside the grid) go into shared
// memory with each hi word's split: every thread issues its loads first,
// then splits and stores; after one barrier each thread sums its points,
// its column's north and centre records carried down from the row above.
template <typename T, int P>
__global__ void __launch_bounds__(32 * kStencilWarps)
stencil_kernel(const T* __restrict__ xh, const T* __restrict__ xl,
               T* __restrict__ yh, T* __restrict__ yl, int ny, int nx,
               int col_tiles, Coeffs<T> k) {
  constexpr int TX = 32, TY = kStencilWarps * P, NT = 32 * kStencilWarps;
  constexpr int HX = TX + 2, E = HX * (TY + 2), K = (E + NT - 1) / NT;
  // The pair (h, l) and the split (hi, lo) in two arrays: a warp reads
  // 32 consecutive records of 8 or 16 bytes, without bank conflicts.
  __shared__ Pair<T> sp[E], ss[E];
  const int tid = threadIdx.x;
  const int c0 = int(blockIdx.x % col_tiles) * TX;
  const int r0 = int(blockIdx.x / col_tiles) * TY;
  T h[K], l[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int e = tid + t * NT;
    const int r = r0 - 1 + e / HX, c = c0 - 1 + e % HX;
    const bool ok = e < E && r >= 0 && r < ny && c >= 0 && c < nx;
    const int64_t at = ok ? int64_t(r) * nx + c : 0;
    h[t] = ok ? __ldg(xh + at) : T(0);
    l[t] = ok ? __ldg(xl + at) : T(0);
  }
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int e = tid + t * NT;
    if (e < E) {
      T hi, lo;
      split_(h[t], hi, lo);
      sp[e] = Pair<T>{h[t], l[t]};
      ss[e] = Pair<T>{hi, lo};
    }
  }
  __syncthreads();
  const int tx = tid % TX, c = c0 + tx;
  if (c >= nx) return;
  const int rr0 = (tid / TX) * P;
  int at = (rr0 + 1) * HX + tx + 1;
  SplitWord<T> north = record(sp, ss, at - HX), centre = record(sp, ss, at);
#pragma unroll
  for (int p = 0; p < P; ++p, at += HX) {
    const int r = r0 + rr0 + p;
    if (r >= ny) return;
    const SplitWord<T> south = record(sp, ss, at + HX);
    T ah, al, th, tl;
    scale_split(centre, k, 0, ah, al);
    scale_split(record(sp, ss, at - 1), k, 1, th, tl);
    df_add(ah, al, th, tl, ah, al);
    scale_split(record(sp, ss, at + 1), k, 2, th, tl);
    df_add(ah, al, th, tl, ah, al);
    scale_split(north, k, 3, th, tl);
    df_add(ah, al, th, tl, ah, al);
    scale_split(south, k, 4, th, tl);
    df_add(ah, al, th, tl, ah, al);
    yh[int64_t(r) * nx + c] = ah;
    yl[int64_t(r) * nx + c] = al;
    north = centre;
    centre = south;
  }
}

// coeffs: the five coefficients, then their hi halves, then their lo
// halves, each exact in T.
template <typename T>
int stencil(const void* xh, const void* xl, void* yh, void* yl, int64_t ny,
            int64_t nx, int64_t P, const double* coeffs, void* stream) {
  if (ny <= 0 || nx <= 0 || ny > INT32_MAX || nx > INT32_MAX)
    return int(cudaErrorInvalidValue);
  const int64_t col_tiles = (nx + 31) / 32;
  const int64_t tile_rows = kStencilWarps * P;
  const int64_t blocks = col_tiles * ((ny + tile_rows - 1) / tile_rows);
  if (blocks > INT32_MAX) return int(cudaErrorInvalidConfiguration);
  Coeffs<T> k;
  for (int t = 0; t < 5; ++t) {
    k.v[t] = T(coeffs[t]);
    k.hi[t] = T(coeffs[5 + t]);
    k.lo[t] = T(coeffs[10 + t]);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto x_h = static_cast<const T*>(xh);
  const auto x_l = static_cast<const T*>(xl);
  const auto y_h = static_cast<T*>(yh);
  const auto y_l = static_cast<T*>(yl);
  const unsigned nb = unsigned(blocks), nt = 32 * kStencilWarps;
#define DF_STENCIL_CASE(PP)                                                    \
  if (P == PP) {                                                               \
    stencil_kernel<T, PP><<<nb, nt, 0, s>>>(x_h, x_l, y_h, y_l, int(ny),       \
                                            int(nx), int(col_tiles), k);       \
    return int(cudaGetLastError());                                            \
  }
  DF_STENCIL_CASE(1) DF_STENCIL_CASE(2) DF_STENCIL_CASE(4)
#undef DF_STENCIL_CASE
  return int(cudaErrorInvalidValue);
}

}  // namespace

#define DF_ENTRIES(SUFFIX, T)                                                  \
  extern "C" int df_project##SUFFIX(                                           \
      const void* Vh, const void* Vl, int64_t ld, const void* wh,              \
      const void* wl, int64_t n, int64_t rows, int64_t m1, int64_t threads,    \
      int64_t C, int64_t G, int64_t L, int64_t stage, void* part,              \
      int64_t part_words, void* arrivals, int64_t arrival_slots, void* ch,     \
      void* cl, void* acc_h, void* acc_l, void* stream) {                      \
    return project<T>(Vh, Vl, ld, wh, wl, n, rows, m1, threads, C, G, L,       \
                      stage, part, part_words, arrivals, arrival_slots, ch,    \
                      cl, acc_h, acc_l, stream);                               \
  }                                                                            \
  extern "C" int df_axpy##SUFFIX(                                              \
      const void* wh, const void* wl, const void* hh, const void* hl,          \
      const void* Vh, const void* Vl, int64_t n, int64_t rows,                 \
      int64_t threads, int64_t C, int64_t G, int64_t L, int64_t U,             \
      int64_t stage, int64_t ld, int64_t ranks, int64_t k, int64_t h_off,      \
      void* fold_h, void* fold_l, void* part, int64_t part_words,              \
      void* arrivals, int64_t arrival_slots, void* outh, void* outl,           \
      void* sum, void* stream) {                                               \
    return axpy<T>(wh, wl, hh, hl, Vh, Vl, n, rows, threads, C, G, L, U,       \
                   stage, ld, ranks, k, h_off, fold_h, fold_l, part,           \
                   part_words, arrivals, arrival_slots, outh, outl, sum,       \
                   stream);                                                    \
  }                                                                            \
  extern "C" int df_normalize##SUFFIX(                                         \
      const void* w1h, const void* w1l, const void* s1h, const void* s1l,      \
      const void* w2h, const void* w2l, const void* s2h, const void* s2l,      \
      const void* r2h, const void* r2l, int64_t n, const void* h1h,            \
      const void* h1l, const void* ch, const void* cl, int64_t m1, void* Hh,   \
      void* Hl, int64_t ld, int64_t row, void* flag, void* outh, void* outl,   \
      int64_t s2_ld, int64_t s2_ranks, void* stream) {                         \
    using P = const T*;                                                        \
    return normalize<T>(                                                       \
        NormalizeArgs<T>{P(w1h), P(w1l), P(s1h), P(s1l), P(w2h), P(w2l),       \
                         P(s2h), P(s2l), P(r2h), P(r2l), P(h1h), P(h1l),       \
                         P(ch), P(cl), static_cast<T*>(Hh),                    \
                         static_cast<T*>(Hl), static_cast<T*>(flag),           \
                         static_cast<T*>(outh), static_cast<T*>(outl), n, m1,  \
                         ld, row},                                             \
        s2_ld, s2_ranks, stream);                                              \
  }                                                                            \
  extern "C" int df_basis_change##SUFFIX(                                      \
      const void* Vh, const void* Vl, const void* Qh, const void* Ql,          \
      int64_t m1, int64_t n, int64_t rows, int64_t R, int64_t C,               \
      int64_t warps, void* outh, void* outl, void* stream) {                   \
    return basis_change<T>(Vh, Vl, Qh, Ql, m1, n, rows, R, C, warps, outh,     \
                           outl, stream);                                      \
  }                                                                            \
  extern "C" int stencil5_df##SUFFIX(const void* xh, const void* xl, void* yh, \
                                     void* yl, int64_t ny, int64_t nx,         \
                                     int64_t P, const double* coeffs,          \
                                     void* stream) {                           \
    return stencil<T>(xh, xl, yh, yl, ny, nx, P, coeffs, stream);              \
  }                                                                            \
  extern "C" int df_rank_sum##SUFFIX(                                          \
      const void* hi, const void* lo, int64_t ld, int64_t P, int64_t k,        \
      void* outh, void* outl, void* acc_h, void* acc_l, void* stream) {        \
    return rank_sum<T>(hi, lo, ld, P, k, outh, outl, acc_h, acc_l, stream);    \
  }

DF_ENTRIES(_f32, float)
DF_ENTRIES(_f64, double)
