// Constant-coefficient 5-point stencil matvec on an (ny, nx) row-major grid
// with a zero Dirichlet boundary, for NVIDIA Hopper (sm_90a):
//
//   y[i,j] = c*x[i,j] + w*x[i,j-1] + e*x[i,j+1] + n*x[i-1,j] + s*x[i+1,j]
//
// Replaces both TPU kernels of arnoldimethod_tpu/ops/stencil_pallas.py:
// `stencil5_matvec_sliding` (_sliding_kernel) and `stencil5_matvec`
// (_kernel + _halo_copy).  They compute the same function and differ only
// in how they stage rows through VMEM, which has no counterpart here.
//
// Bound: memory.  One matvec moves x in and y out, 8 bytes per point in
// float32 (16 in float64), for 9 flops; nothing in the kernel comes close
// to the card's arithmetic rate.  Design:
//   - a block is a strip of TILE_COLS columns by `tile_rows` rows; each
//     thread walks one column down the strip, carrying the north and
//     centre values in registers, so every x element of the strip is read
//     from memory once by its own thread (the sliding-window idea of the
//     TPU kernel, done per thread);
//   - neighbouring threads read neighbouring addresses (coalesced); the
//     west/east reads hit the lines the neighbours just loaded, in L1;
//   - the two halo rows of a strip are re-read by the strips above and
//     below, mostly from L2 (50 MB);
//   - the ragged right and bottom edges are masked, so ny and nx need no
//     divisibility; the zero boundary is the masked-out neighbour reads;
//   - y is written out of place: blocks run in parallel and in no order,
//     so writing into x would race with the neighbours' halo reads.
//
// The Chebyshev filter (arnoldimethod_torch/transforms.py) replaces XLA's
// fusion of the three-term recurrence of arnoldimethod_tpu/transforms.py:
// 199-231 (not a Pallas kernel).  Each point of each degree step is
//
//   y = p * ((A x - shift * x) * inv_e) - q * z      (z = y_{k-1})
//
// computed by one function, `cheb_point`, whose roundings are pinned, so
// that every form below gives the same bits.  Two forms:
//   - one step a launch (`stencil5_cheb_*`): the matvec kernel above with
//     that epilogue; reads x and z, writes y, 12 bytes a point in float32.
//     z may be the same buffer as y (each thread reads z[k] once, before it
//     writes y[k]); y must never be x.  Kept as the reference the fused
//     form is held to bit for bit;
//   - up to 16 steps a launch (8 in float64; `stencil5_cheb_run_*`,
//     temporal blocking), the filter's path.  One step moves 12 bytes a
//     point for 9 flops, far below the card's balance, so a one-step kernel
//     is bound by memory however it is written; the run keeps the levels
//     between its input and its last two outputs on chip, so a launch of L
//     steps reads y_t (with a halo) and y_{t-1} and writes y_{t+L-1} and
//     y_{t+L}: ~16 bytes a point for L steps.  What bounds it then is the
//     issue of its instructions (9 floating-point ones a point a step, and
//     the shared-memory and bookkeeping ones around them).  Design (2.5-D
//     streaming, the matvec's sliding column deepened):
//       * a block of THREADS threads, K adjacent columns a thread, owns
//         K * THREADS - 2L output columns plus L halo columns on each side,
//         and walks its rows [r0, r1) from L rows above to L rows below;
//       * at row step r it loads level 0 (y_t) at row r and level l
//         computes its row r - l: level l lags level l-1 by one row, so its
//         south neighbour is what level l-1 computed in the same step;
//       * each thread keeps level l-1's north and centre of its K columns
//         for level l in registers, so its inner west and east neighbours
//         are registers too; its outer two come from the neighbouring
//         threads' edge values, one shared row a level for each edge,
//         double-buffered, so one __syncthreads a row step serves every
//         level; z of level l is level l-2's value, which is level l-1's
//         north (level 1 reads y_{t-1}, or none in the filter's first
//         launch);
//       * K columns a thread give each thread K independent chains through
//         the L levels: the levels of a column are one dependent chain;
//       * every level of every row step is computed, without branches, so
//         the shared reads issue together; the halo's values go stale one
//         column and one row a level from the block's edge and never reach
//         an output point;
//       * a point outside the grid is zero at every level and is never
//         computed by the formula (the Dirichlet boundary); ny and nx need
//         no divisibility;
//       * the outputs are written out of place: neighbouring blocks read
//         the input's halo, and both inputs, so the filter rotates two
//         pairs of buffers and never writes its caller's vector;
//       * the (p, q) of the L steps are passed by value in the launch's
//         parameter block; a kernel is instantiated for each L up to the
//         depth, so the degree's remainder is one shorter launch.
//     The rows a block are chosen by the Python wrapper
//     (arnoldimethod_torch/ops/stencil.py, `cheb_plan`) from the grid and
//     the card's SM count and occupancy: the tallest blocks that fill the
//     card in one wave.
// The C entries launch on the caller's stream, never synchronise, and
// return cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE_COLS = 128;  // threads per block, one column each

// What a thread writes for its point: the matvec itself, or a Chebyshev
// step without (q = 0) or with the y_{k-1} term.
enum Epilogue { kMatvec = 0, kStep = 1, kStepZ = 2 };

template <typename T>
struct ChebStep {
  const T* z;  // y_{k-1}; may be the same buffer as y; null for kStep
  T shift, inv_e, p, q;
};

template <typename T>
struct Stencil {
  T c, w, e, n, s;
};

// Rounded products and fused multiply-adds, pinned: nvcc contracts a * b + c
// by context, so an expression left to it may round differently in two
// kernels.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// One point of one Chebyshev degree step: y = p * L(x) - q * z, or
// p * L(x) without z, L(x) = (A x - shift * x) * inv_e.  Every form calls
// this one function.  Its roundings are those nvcc chose for the one-step
// kernel's expression (c*x + w*W + e*E + n*N + s*S - shift*x) * inv_e * p
// - q * z, fixed here: ax = s*S + (n*N + (e*E + (c*x + w*W))) in fused
// steps, then (ax - shift*x) fused, times inv_e, and p*lv - (q*z) fused.
template <bool HAS_Z, typename T>
__device__ __forceinline__ T cheb_point(const Stencil<T>& a, T shift,
                                        T inv_e, T p, T q, T centre, T west,
                                        T east, T north, T south, T z) {
  const T ax = fma_rn(
      a.s, south,
      fma_rn(a.n, north,
             fma_rn(a.e, east, fma_rn(a.c, centre, mul_rn(a.w, west)))));
  const T lv = mul_rn(fma_rn(-shift, centre, ax), inv_e);
  if constexpr (HAS_Z) {
    return fma_rn(p, lv, -mul_rn(q, z));
  } else {
    return mul_rn(p, lv);
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(TILE_COLS)
stencil5_kernel(const T* __restrict__ x, T* y, int64_t ny, int64_t nx,
                int64_t col_blocks, int64_t tile_rows, T c, T w, T e, T n,
                T s, ChebStep<T> step) {
  const int64_t cb = blockIdx.x % col_blocks;
  const int64_t rb = blockIdx.x / col_blocks;
  const int64_t j = cb * TILE_COLS + threadIdx.x;
  if (j >= nx) return;
  const int64_t r0 = rb * tile_rows;
  const int64_t r1 = r0 + tile_rows < ny ? r0 + tile_rows : ny;
  const bool has_w = j > 0;
  const bool has_e = j + 1 < nx;

  T north = r0 > 0 ? __ldg(x + (r0 - 1) * nx + j) : T(0);
  T centre = __ldg(x + r0 * nx + j);
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t k = r * nx + j;
    const T south = r + 1 < ny ? __ldg(x + k + nx) : T(0);
    const T west = has_w ? __ldg(x + k - 1) : T(0);
    const T east = has_e ? __ldg(x + k + 1) : T(0);
    if constexpr (EPI == kMatvec) {
      y[k] = c * centre + w * west + e * east + n * north + s * south;
    } else if constexpr (EPI == kStepZ) {
      y[k] = cheb_point<true>(Stencil<T>{c, w, e, n, s}, step.shift,
                              step.inv_e, step.p, step.q, centre, west, east,
                              north, south, step.z[k]);
    } else {
      y[k] = cheb_point<false>(Stencil<T>{c, w, e, n, s}, step.shift,
                               step.inv_e, step.p, T(0), centre, west, east,
                               north, south, T(0));
    }
    north = centre;
    centre = south;
  }
}

// The fused run's shape by dtype: K columns a thread, THREADS threads a
// block (K * THREADS columns, DEPTH halo columns a side at most) and
// the most steps a launch.  Registers hold 2 K values a level, shared
// memory 4 values a thread a level (33 KB a block in both words); float32
// takes 4 columns a thread, float64 2 (measured fastest on an H100 among
// 1, 2 and 4).
template <typename T>
struct RunShape;
template <>
struct RunShape<float> {
  static constexpr int K = 4, THREADS = 128, DEPTH = 16;
};
template <>
struct RunShape<double> {
  static constexpr int K = 2, THREADS = 128, DEPTH = 8;
};

// The (p, q) of each level of a run, by value in the parameter block.
template <typename T, int L>
struct ChebRun {
  T p[L], q[L];
};

// L degree steps: y_lo = level L - 1, y_hi = level L of the recurrence
// started from x = y_t and z = y_{t-1} (z null: level 1 is the filter's
// first step, without z, and level 0 is x).  y_lo null: not written (the
// filter's last launch).  Every level of every row step is computed
// (branch-free, so that the shared reads of a row step issue together);
// the rows a level computes outside its block's cone are stale and read
// only by other stale points.
template <typename T, int L>
__global__ void __launch_bounds__(RunShape<T>::THREADS)
stencil5_cheb_run_kernel(const T* __restrict__ x, const T* __restrict__ z,
                         T* __restrict__ y_lo, T* __restrict__ y_hi, int ny,
                         int nx, int col_blocks, int tile_rows, Stencil<T> a,
                         T shift, T inv_e, ChebRun<T, L> run) {
  constexpr int K = RunShape<T>::K, NT = RunShape<T>::THREADS;
  // first[b][l] / last[b][l]: level l's newest row at each thread's first
  // and last column, the thread's at slot t + 1; slots 0 and NT + 1 stay
  // zero.
  __shared__ T first[2][L][NT + 2];
  __shared__ T last[2][L][NT + 2];
  const int t = threadIdx.x;
  const int j0 = int(blockIdx.x % col_blocks) * (NT * K - 2 * L) - L + t * K;
  const int r0 = int(blockIdx.x / col_blocks) * tile_rows;
  const int r1 = r0 + tile_rows < ny ? r0 + tile_rows : ny;
  bool in_grid[K], owns[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    in_grid[k] = j0 + k >= 0 && j0 + k < nx;
    owns[k] = in_grid[k] && t * K + k >= L && t * K + k < NT * K - L;
  }
  if (t < 2) {
    for (int b = 0; b < 2; ++b)
      for (int l = 0; l < L; ++l)
        first[b][l][t * (NT + 1)] = last[b][l][t * (NT + 1)] = T(0);
  }
  // north[l - 1], centre[l - 1]: level l-1 at the row above the one that
  // level l computes next, and at that row.
  T north[L][K], centre[L][K];
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int k = 0; k < K; ++k) north[l][k] = centre[l][k] = T(0);

  const int begin = r0 - L > 0 ? r0 - L : 0;
  const int end = r1 + L;
  // The next row step's level-0 values and level 1's z, loaded a row step
  // ahead.
  T x_next[K], z_next[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x_next[k] = in_grid[k] && begin < ny
                    ? __ldg(x + int64_t(begin) * nx + j0 + k)
                    : T(0);
    z_next[k] = z != nullptr && in_grid[k] && begin > 0
                    ? __ldg(z + int64_t(begin - 1) * nx + j0 + k)
                    : T(0);
  }
  int b = 0;
  for (int r = begin; r < end; ++r, b ^= 1) {
    T cur[K], zl[K], below[K];  // level l-1 at row r - l + 1; z; level L-1
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cur[k] = x_next[k];
      zl[k] = z_next[k];
      x_next[k] = in_grid[k] && r + 1 < ny
                      ? __ldg(x + int64_t(r + 1) * nx + j0 + k)
                      : T(0);
      z_next[k] = z != nullptr && in_grid[k] && r < ny
                      ? __ldg(z + int64_t(r) * nx + j0 + k)
                      : T(0);
    }
    first[b][0][t + 1] = cur[0];
    last[b][0][t + 1] = cur[K - 1];
#pragma unroll
    for (int l = 1; l <= L; ++l) {
      // Level l computes row r - l.  Rows outside the grid are zero;
      // rows above r0 - L + l are the stale warm-up of an inner block.
      const int i = r - l;
      const bool row_ok = i >= 0 && i < ny && i >= r0 - L + l;
      const T west = last[b ^ 1][l - 1][t];
      const T east = first[b ^ 1][l - 1][t + 2];
      T out[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T cv = centre[l - 1][k];
        const T wv = k == 0 ? west : centre[l - 1][k > 0 ? k - 1 : 0];
        const T ev = k == K - 1 ? east : centre[l - 1][k + 1 < K ? k + 1 : 0];
        T v;
        if (l == 1 && z == nullptr)
          v = cheb_point<false>(a, shift, inv_e, run.p[0], T(0), cv, wv, ev,
                                north[l - 1][k], cur[k], T(0));
        else
          v = cheb_point<true>(a, shift, inv_e, run.p[l - 1], run.q[l - 1],
                               cv, wv, ev, north[l - 1][k], cur[k], zl[k]);
        // A point outside the grid stays zero at every level.
        out[k] = row_ok && in_grid[k] ? v : T(0);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        zl[k] = north[l - 1][k];  // level l+1's z: level l-1 at its row
        below[k] = centre[l - 1][k];
        north[l - 1][k] = centre[l - 1][k];
        centre[l - 1][k] = cur[k];
        cur[k] = out[k];
      }
      if (l < L) {
        first[b][l][t + 1] = out[0];
        last[b][l][t + 1] = out[K - 1];
      }
    }
    const int i = r - L;
    if (i >= r0 && i < r1) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (owns[k]) {
          y_hi[int64_t(i) * nx + j0 + k] = cur[k];
          if (y_lo != nullptr) y_lo[int64_t(i) * nx + j0 + k] = below[k];
        }
    }
    __syncthreads();
  }
}

template <typename T, int EPI>
int launch(const void* x, void* y, int64_t ny, int64_t nx, double c,
           double w, double e, double n, double s, ChebStep<T> step,
           int64_t tile_rows, void* stream) {
  if (ny <= 0 || nx <= 0 || tile_rows <= 0) return int(cudaErrorInvalidValue);
  const int64_t col_blocks = (nx + TILE_COLS - 1) / TILE_COLS;
  const int64_t row_blocks = (ny + tile_rows - 1) / tile_rows;
  const int64_t blocks = col_blocks * row_blocks;
  if (blocks > INT32_MAX) return int(cudaErrorInvalidConfiguration);
  stencil5_kernel<T, EPI><<<dim3(unsigned(blocks)), dim3(TILE_COLS), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), ny, nx, col_blocks,
      tile_rows, T(c), T(w), T(e), T(n), T(s), step);
  return int(cudaGetLastError());
}

template <typename T>
int launch_step(const void* x, const void* z, void* y, int64_t ny,
                int64_t nx, double c, double w, double e, double n, double s,
                double shift, double inv_e, double p, double q,
                int64_t tile_rows, void* stream) {
  const ChebStep<T> step{static_cast<const T*>(z), T(shift), T(inv_e), T(p),
                         T(q)};
  if (z == nullptr)
    return launch<T, kStep>(x, y, ny, nx, c, w, e, n, s, step, tile_rows,
                            stream);
  return launch<T, kStepZ>(x, y, ny, nx, c, w, e, n, s, step, tile_rows,
                           stream);
}

template <typename T, int L>
int launch_run_at(const void* x, const void* z, void* y_lo, void* y_hi,
                  int64_t ny, int64_t nx, Stencil<T> a, T shift, T inv_e,
                  const double* p, const double* q, int64_t tile_rows,
                  void* stream) {
  ChebRun<T, L> run{};
  for (int l = 0; l < L; ++l) {
    run.p[l] = T(p[l]);
    run.q[l] = T(q[l]);
  }
  const int64_t width = RunShape<T>::THREADS * RunShape<T>::K - 2 * L;
  const int64_t col_blocks = (nx + width - 1) / width;
  const int64_t row_blocks = (ny + tile_rows - 1) / tile_rows;
  const int64_t blocks = col_blocks * row_blocks;
  if (blocks > INT32_MAX) return int(cudaErrorInvalidConfiguration);
  stencil5_cheb_run_kernel<T, L><<<dim3(unsigned(blocks)),
                                   dim3(RunShape<T>::THREADS), 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(z),
      static_cast<T*>(y_lo), static_cast<T*>(y_hi), int(ny), int(nx),
      int(col_blocks), int(tile_rows), a, shift, inv_e, run);
  return int(cudaGetLastError());
}

// The run of `levels` steps, one kernel instantiated for each count up to
// the dtype's depth (the degree's remainder is a shorter launch).
template <typename T, int L = 1>
int launch_run(const void* x, const void* z, void* y_lo, void* y_hi,
               int64_t ny, int64_t nx, double c, double w, double e, double n,
               double s, double shift, double inv_e, const double* p,
               const double* q, int64_t levels, int64_t tile_rows,
               void* stream) {
  if (L == 1 && (ny <= 0 || nx <= 0 || ny > INT32_MAX || nx > INT32_MAX ||
                 tile_rows <= 0 || tile_rows > INT32_MAX || levels < 1 ||
                 levels > RunShape<T>::DEPTH || y_hi == nullptr ||
                 p == nullptr || q == nullptr))
    return int(cudaErrorInvalidValue);
  if (levels != L) {
    if constexpr (L < RunShape<T>::DEPTH)
      return launch_run<T, L + 1>(x, z, y_lo, y_hi, ny, nx, c, w, e, n, s,
                                  shift, inv_e, p, q, levels, tile_rows,
                                  stream);
    return int(cudaErrorInvalidValue);
  }
  return launch_run_at<T, L>(x, z, y_lo, y_hi, ny, nx,
                             Stencil<T>{T(c), T(w), T(e), T(n), T(s)},
                             T(shift), T(inv_e), p, q, tile_rows, stream);
}

}  // namespace

extern "C" int stencil5_f32(const void* x, void* y, int64_t ny, int64_t nx,
                            double c, double w, double e, double n, double s,
                            int64_t tile_rows, void* stream) {
  return launch<float, kMatvec>(x, y, ny, nx, c, w, e, n, s, {}, tile_rows,
                                stream);
}

extern "C" int stencil5_f64(const void* x, void* y, int64_t ny, int64_t nx,
                            double c, double w, double e, double n, double s,
                            int64_t tile_rows, void* stream) {
  return launch<double, kMatvec>(x, y, ny, nx, c, w, e, n, s, {}, tile_rows,
                                 stream);
}

// One Chebyshev degree step, y = p * ((A x - shift * x) * inv_e) - q * z;
// z null means the step has no y_{k-1} term (y = p * L(x)).
extern "C" int stencil5_cheb_f32(const void* x, const void* z, void* y,
                                 int64_t ny, int64_t nx, double c, double w,
                                 double e, double n, double s, double shift,
                                 double inv_e, double p, double q,
                                 int64_t tile_rows, void* stream) {
  return launch_step<float>(x, z, y, ny, nx, c, w, e, n, s, shift, inv_e, p,
                            q, tile_rows, stream);
}

extern "C" int stencil5_cheb_f64(const void* x, const void* z, void* y,
                                 int64_t ny, int64_t nx, double c, double w,
                                 double e, double n, double s, double shift,
                                 double inv_e, double p, double q,
                                 int64_t tile_rows, void* stream) {
  return launch_step<double>(x, z, y, ny, nx, c, w, e, n, s, shift, inv_e, p,
                             q, tile_rows, stream);
}

// Up to the dtype's depth (16 in float32, 8 in float64) Chebyshev steps in
// one launch: from
// x = y_t and z = y_{t-1} (null: the filter's first step comes first),
// y_lo = y_{t+L-1} (null: not written) and y_hi = y_{t+L}, with the L
// steps' (p, q) in p[0..L) and q[0..L) (q[0] unused without z).  The
// outputs must overlap neither input.
extern "C" int stencil5_cheb_run_f32(const void* x, const void* z, void* y_lo,
                                     void* y_hi, int64_t ny, int64_t nx,
                                     double c, double w, double e, double n,
                                     double s, double shift, double inv_e,
                                     const double* p, const double* q,
                                     int64_t levels, int64_t tile_rows,
                                     void* stream) {
  return launch_run<float>(x, z, y_lo, y_hi, ny, nx, c, w, e,
                          n, s, shift, inv_e, p, q, levels, tile_rows,
                          stream);
}

extern "C" int stencil5_cheb_run_f64(const void* x, const void* z, void* y_lo,
                                     void* y_hi, int64_t ny, int64_t nx,
                                     double c, double w, double e, double n,
                                     double s, double shift, double inv_e,
                                     const double* p, const double* q,
                                     int64_t levels, int64_t tile_rows,
                                     void* stream) {
  return launch_run<double>(x, z, y_lo, y_hi, ny, nx, c, w, e,
                           n, s, shift, inv_e, p, q, levels, tile_rows,
                           stream);
}

// The run's columns a block and most steps a launch by dtype, for the
// wrapper to check its own constants against.
extern "C" void stencil5_cheb_run_shape(int64_t* columns_f32,
                                        int64_t* depth_f32,
                                        int64_t* columns_f64,
                                        int64_t* depth_f64) {
  *columns_f32 = RunShape<float>::THREADS * RunShape<float>::K;
  *depth_f32 = RunShape<float>::DEPTH;
  *columns_f64 = RunShape<double>::THREADS * RunShape<double>::K;
  *depth_f64 = RunShape<double>::DEPTH;
}

// Blocks of the full-depth run kernel resident on one SM at a time (the
// plan fills the card with one wave of them).
extern "C" int stencil5_cheb_run_blocks_per_sm_f32(int* blocks) {
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, stencil5_cheb_run_kernel<float, RunShape<float>::DEPTH>,
      RunShape<float>::THREADS, 0));
}

extern "C" int stencil5_cheb_run_blocks_per_sm_f64(int* blocks) {
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, stencil5_cheb_run_kernel<double, RunShape<double>::DEPTH>,
      RunShape<double>::THREADS, 0));
}
