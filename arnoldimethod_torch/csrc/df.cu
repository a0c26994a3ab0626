// Double-word kernels of the extended-precision Arnoldi path, for NVIDIA
// Hopper (sm_90a).  A value is the unevaluated sum hi + lo of two words of
// type T (float or double); every kernel is templated on T.
//
//   df_project       c[j] = sum_i V[j, i] * w[i] for rows j < rows, zero
//                    beyond; optionally acc[j] <- acc[j] + c[j]
//   df_axpy          out = w - sum_{j < rows} h_j * V[j], j in order
//   df_mul_by        out = w * s for a double-word scalar s
//   df_basis_change  out[i] = sum_j Q[j, i] * V[j], j in order, i < rows
//   stencil5_df      the Dirichlet 5-point stencil on a double-word vector
//
// None replaces a Pallas kernel: the JAX package runs this work as XLA
// loops (arnoldimethod_tpu/ops/df32.py df_sum, df_axpy_update_df;
// ops/df_expansion.py _df_basis_change_impl; models/operators.py
// Stencil5Operator.matvec_df).  Each kernel computes exactly the products
// and sums of the plain PyTorch version in arnoldimethod_torch/ops/df32.py
// and ops/df.py, in the same order, so its result is bitwise equal to it.
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
// both operands were split beforehand.  df_project, df_axpy, df_mul_by and
// stencil5_df touch each word a few times and are bound by memory;
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
//          tree over the row's G * C partials, the first levels in device
//          memory while they outgrow the shared stage, and resets the
//          counter (so CUDA-graph replays start from zero).  With G = 1
//          the block finishes the row itself.
//     A block takes one row: blocks of two rows sharing their w loads
//     measured no faster on an H100 (w's re-reads come from L2).  Rows
//     past `rows` are zero and, with acc, still go through acc + 0, by
//     block (0, 0).
//   - df_axpy: a thread owns columns and runs the rows j in order.
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
// The C entries launch on the caller's stream, never synchronise, and
// return cudaGetLastError() (or a refusal code) so the wrapper can raise.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }

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

// -- df_project ------------------------------------------------------------

constexpr int kProjectThreads = 256;       // the most threads a block
constexpr size_t kProjectStage = 48 * 1024;  // shared memory a block

// The halving tree of df32.df_sum over the `len` pairs at (sh, sl)[t], down
// to `keep` pairs (powers of two): levels with half >= 32 in shared
// memory, a barrier each; the rest in warp 0 by shuffles.  The lower index
// is the left operand.  Every thread of the block calls it; the result is
// at (sh, sl)[t], t < keep, after its closing barrier.
template <typename T>
__device__ void halve_shared(T* sh, T* sl, int len, int keep) {
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
  __shared__ bool last;
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

  // 2. The block's tree over its T values, down to C.
  T* sh = reinterpret_cast<T*>(smem_raw);
  T* sl = sh + (nt > stage ? nt : stage);
  sh[tid] = ph[0];
  sl[tid] = pl[0];
  __syncthreads();
  halve_shared(sh, sl, nt, C);
  if (G == 1) {  // the block holds the whole row: finish here
    halve_shared(sh, sl, C, 1);
    if (tid == 0) project_out(row, sh[0], sl[0], ch, cl, acc_h, acc_l);
    return;
  }

  // 3. The last block of the row to arrive sums the G * C partials.
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
  if (!last) return;
  __threadfence();
  int64_t len = M;
  for (; len > stage; len /= 2) {  // levels in device memory
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
  for (int t = tid; t < len; t += nt) {
    sh[t] = __ldcg(rh + t);
    sl[t] = __ldcg(rl + t);
  }
  __syncthreads();
  halve_shared(sh, sl, int(len), 1);
  if (tid == 0) {
    project_out(row, sh[0], sl[0], ch, cl, acc_h, acc_l);
    arrivals[row] = 0u;
  }
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

// -- df_axpy and df_mul_by -------------------------------------------------

template <typename T, bool SCALE>
__global__ void __launch_bounds__(256)
axpy_kernel(const T* __restrict__ wh, const T* __restrict__ wl,
            const T* __restrict__ hh, const T* __restrict__ hl,
            const T* __restrict__ Vh, const T* __restrict__ Vl, int64_t ld,
            int64_t n, int64_t rows, T sh, T sl, T* outh, T* outl) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T ah = wh[i], al = wl[i];
    if constexpr (SCALE) {
      df_mul(ah, al, sh, sl, ah, al);
    } else {
      for (int64_t j = 0; j < rows; ++j) {
        T th, tl;
        df_mul(__ldg(hh + j), __ldg(hl + j), __ldg(Vh + j * ld + i),
               __ldg(Vl + j * ld + i), th, tl);
        df_add(ah, al, -th, -tl, ah, al);
      }
    }
    outh[i] = ah;
    outl[i] = al;
  }
}

int grid_for(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  return int(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T>
int axpy(const void* wh, const void* wl, const void* hh, const void* hl,
         const void* Vh, const void* Vl, int64_t ld, int64_t n, int64_t rows,
         void* outh, void* outl, void* stream) {
  if (n < 1 || rows < 0) return int(cudaErrorInvalidValue);
  axpy_kernel<T, false><<<grid_for(n, 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(wh), static_cast<const T*>(wl),
      static_cast<const T*>(hh), static_cast<const T*>(hl),
      static_cast<const T*>(Vh), static_cast<const T*>(Vl), ld, n, rows, T(0),
      T(0), static_cast<T*>(outh), static_cast<T*>(outl));
  return int(cudaGetLastError());
}

template <typename T>
int mul_by(const void* wh, const void* wl, double sh, double sl, int64_t n,
           void* outh, void* outl, void* stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  axpy_kernel<T, true><<<grid_for(n, 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(wh), static_cast<const T*>(wl), nullptr, nullptr,
      nullptr, nullptr, 0, n, 0, T(sh), T(sl), static_cast<T*>(outh),
      static_cast<T*>(outl));
  return int(cudaGetLastError());
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
  T p, e, th, tl;
  two_prod_split(q.h, q.hi, q.lo, vh, vhi, vlo, p, e);
  e = add_(e, add_(mul_(q.h, vl), mul_(q.l, vh)));
  quick_two_sum(p, e, th, tl);
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
  extern "C" int df_axpy##SUFFIX(const void* wh, const void* wl,               \
                                 const void* hh, const void* hl,               \
                                 const void* Vh, const void* Vl, int64_t ld,   \
                                 int64_t n, int64_t rows, void* outh,          \
                                 void* outl, void* stream) {                   \
    return axpy<T>(wh, wl, hh, hl, Vh, Vl, ld, n, rows, outh, outl, stream);   \
  }                                                                            \
  extern "C" int df_mul_by##SUFFIX(const void* wh, const void* wl, double sh,  \
                                   double sl, int64_t n, void* outh,           \
                                   void* outl, void* stream) {                 \
    return mul_by<T>(wh, wl, sh, sl, n, outh, outl, stream);                   \
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
  }

DF_ENTRIES(_f32, float)
DF_ENTRIES(_f64, double)
