// Double-word kernels of the extended-precision Arnoldi path, for NVIDIA
// Hopper (sm_90a).  A value is the unevaluated sum hi + lo of two words of
// type T (float or double); every kernel is templated on T.
//
//   df_project       c[j] = sum_i V[j, i] * w[i] for rows j < rows, zero
//                    beyond; optionally acc[j] <- acc[j] + c[j]
//   df_axpy          out = w - sum_{j < rows} h_j * V[j], j in order
//   df_mul_by        out = w * s for a double-word scalar s
//   df_basis_change  out[i] = sum_j Q[j, i] * V[j], j in order
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
// Bound.  Memory, not arithmetic: a double-word multiply-add is ~35
// operations on 2 words (8 bytes in float32), 4.4 operations a byte,
// under the card's ~20 (float32, 67 TFLOP/s over 3.35 TB/s); in float64
// ~2.2 a byte against ~10.  Tensor cores cannot carry the compensation.
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
//   - df_basis_change: a block stages a tile of V's columns (all rows,
//     both words) in shared memory; each thread accumulates outputs (i, c)
//     over j in order, with Q[j, i] read uniformly across the warp.  The
//     output goes out of place into a temporary.
//   - stencil5_df: a thread walks one column down a strip of rows, as
//     stencil5.cu does, carrying the north and centre pairs in registers;
//     missing neighbours are (0, 0) and still go through the arithmetic.
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

template <typename T>
__device__ __forceinline__ void two_prod(T a, T b, T& p, T& e) {
  const T split = Split<T>::value;
  p = mul_(a, b);
  const T ac = mul_(split, a);
  const T ta = sub_(ac, a);
  const T ahi = sub_(ac, ta);
  const T alo = sub_(a, ahi);
  const T bc = mul_(split, b);
  const T tb = sub_(bc, b);
  const T bhi = sub_(bc, tb);
  const T blo = sub_(b, bhi);
  const T e1 = sub_(mul_(ahi, bhi), p);
  const T e2 = add_(e1, mul_(ahi, blo));
  const T e3 = add_(e2, mul_(alo, bhi));
  e = add_(e3, mul_(alo, blo));
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

constexpr int kBasisThreads = 256;
// The most a block stages: the default dynamic shared-memory limit, so no
// attribute is needed; a taller basis takes a narrower column tile.
constexpr size_t kBasisSmem = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kBasisThreads)
basis_kernel(const T* __restrict__ Vh, const T* __restrict__ Vl,
             const T* __restrict__ Qh, const T* __restrict__ Ql, int64_t m1,
             int64_t n, int tc, T* __restrict__ outh, T* __restrict__ outl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vh = reinterpret_cast<T*>(smem_raw);
  T* vl = vh + m1 * tc;
  const int64_t c0 = int64_t(blockIdx.x) * tc;
  for (int64_t k = threadIdx.x; k < m1 * tc; k += blockDim.x) {
    const int64_t j = k / tc, col = c0 + k % tc;
    vh[k] = col < n ? Vh[j * n + col] : T(0);
    vl[k] = col < n ? Vl[j * n + col] : T(0);
  }
  __syncthreads();
  const int cx = threadIdx.x % tc;
  const int groups = blockDim.x / tc;
  const int64_t col = c0 + cx;
  if (col >= n) return;
  for (int64_t i = threadIdx.x / tc; i < m1; i += groups) {
    T ah = T(0), al = T(0);
    for (int64_t j = 0; j < m1; ++j) {
      T th, tl;
      df_mul(__ldg(Qh + j * m1 + i), __ldg(Ql + j * m1 + i), vh[j * tc + cx],
             vl[j * tc + cx], th, tl);
      df_add(ah, al, th, tl, ah, al);
    }
    outh[i * n + col] = ah;
    outl[i * n + col] = al;
  }
}

template <typename T>
int basis_change(const void* Vh, const void* Vl, const void* Qh,
                 const void* Ql, int64_t m1, int64_t n, void* outh, void* outl,
                 void* stream) {
  if (m1 < 1 || n < 1) return int(cudaErrorInvalidValue);
  // The widest column tile (32 down to 1) whose rows fit the stage.
  int tc = 32;
  while (tc > 1 && size_t(2 * m1 * tc) * sizeof(T) > kBasisSmem) tc /= 2;
  const size_t smem = size_t(2 * m1 * tc) * sizeof(T);
  if (smem > kBasisSmem) return int(cudaErrorInvalidValue);
  const int64_t blocks = (n + tc - 1) / tc;
  if (blocks > INT32_MAX) return int(cudaErrorInvalidConfiguration);
  basis_kernel<T><<<unsigned(blocks), kBasisThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Vh), static_cast<const T*>(Vl),
      static_cast<const T*>(Qh), static_cast<const T*>(Ql), m1, n, tc,
      static_cast<T*>(outh), static_cast<T*>(outl));
  return int(cudaGetLastError());
}

// -- stencil5_df -----------------------------------------------------------

constexpr int kStencilCols = 128;  // threads a block, one column each
constexpr int64_t kStencilRows = 8;  // rows a thread walks

template <typename T>
__global__ void __launch_bounds__(kStencilCols)
stencil_kernel(const T* __restrict__ xh, const T* __restrict__ xl,
               T* __restrict__ yh, T* __restrict__ yl, int64_t ny, int64_t nx,
               int64_t col_blocks, T c, T w, T e, T no, T so) {
  const int64_t cb = blockIdx.x % col_blocks;
  const int64_t rb = blockIdx.x / col_blocks;
  const int64_t j = cb * kStencilCols + threadIdx.x;
  if (j >= nx) return;
  const int64_t r0 = rb * kStencilRows;
  const int64_t r1 = r0 + kStencilRows < ny ? r0 + kStencilRows : ny;
  const bool has_w = j > 0, has_e = j + 1 < nx;
  T nh = r0 > 0 ? __ldg(xh + (r0 - 1) * nx + j) : T(0);
  T nl = r0 > 0 ? __ldg(xl + (r0 - 1) * nx + j) : T(0);
  T ch = __ldg(xh + r0 * nx + j), cl = __ldg(xl + r0 * nx + j);
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t k = r * nx + j;
    const bool has_s = r + 1 < ny;
    const T sh = has_s ? __ldg(xh + k + nx) : T(0);
    const T sl = has_s ? __ldg(xl + k + nx) : T(0);
    const T wh_ = has_w ? __ldg(xh + k - 1) : T(0);
    const T wl_ = has_w ? __ldg(xl + k - 1) : T(0);
    const T eh = has_e ? __ldg(xh + k + 1) : T(0);
    const T el = has_e ? __ldg(xl + k + 1) : T(0);
    T ah, al, th, tl;
    df_scale(ch, cl, c, ah, al);
    df_scale(wh_, wl_, w, th, tl);
    df_add(ah, al, th, tl, ah, al);
    df_scale(eh, el, e, th, tl);
    df_add(ah, al, th, tl, ah, al);
    df_scale(nh, nl, no, th, tl);
    df_add(ah, al, th, tl, ah, al);
    df_scale(sh, sl, so, th, tl);
    df_add(ah, al, th, tl, ah, al);
    yh[k] = ah;
    yl[k] = al;
    nh = ch;
    nl = cl;
    ch = sh;
    cl = sl;
  }
}

template <typename T>
int stencil(const void* xh, const void* xl, void* yh, void* yl, int64_t ny,
            int64_t nx, double c, double w, double e, double n, double s,
            void* stream) {
  if (ny <= 0 || nx <= 0) return int(cudaErrorInvalidValue);
  const int64_t col_blocks = (nx + kStencilCols - 1) / kStencilCols;
  const int64_t blocks = col_blocks * ((ny + kStencilRows - 1) / kStencilRows);
  if (blocks > INT32_MAX) return int(cudaErrorInvalidConfiguration);
  stencil_kernel<T><<<unsigned(blocks), kStencilCols, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xh), static_cast<const T*>(xl),
      static_cast<T*>(yh), static_cast<T*>(yl), ny, nx, col_blocks, T(c),
      T(w), T(e), T(n), T(s));
  return int(cudaGetLastError());
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
  extern "C" int df_basis_change##SUFFIX(const void* Vh, const void* Vl,       \
                                         const void* Qh, const void* Ql,       \
                                         int64_t m1, int64_t n, void* outh,    \
                                         void* outl, void* stream) {           \
    return basis_change<T>(Vh, Vl, Qh, Ql, m1, n, outh, outl, stream);         \
  }                                                                            \
  extern "C" int stencil5_df##SUFFIX(const void* xh, const void* xl, void* yh, \
                                     void* yl, int64_t ny, int64_t nx,         \
                                     double c, double w, double e, double n,   \
                                     double s, void* stream) {                 \
    return stencil<T>(xh, xl, yh, yl, ny, nx, c, w, e, n, s, stream);          \
  }

DF_ENTRIES(_f32, float)
DF_ENTRIES(_f64, double)
