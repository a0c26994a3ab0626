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
// The same kernel, with an epilogue, is one degree step of the Chebyshev
// filter (arnoldimethod_torch/transforms.py):
//
//   y = p * ((A x - shift * x) * inv_e) - q * z
//
// It replaces XLA's fusion of the three-term recurrence of
// arnoldimethod_tpu/transforms.py:199-231 (not a Pallas kernel): one launch
// reads x and z and writes y, 12 bytes per point in float32, where the
// stencil launch plus separate elementwise passes move several times that.
// z may be the same buffer as y (each thread reads z[k] once, before it
// writes y[k]), so the recurrence ping-pongs between two buffers; y must
// never be x, whose halo the neighbouring threads read.
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
    const T ax = c * centre + w * west + e * east + n * north + s * south;
    if constexpr (EPI == kMatvec) {
      y[k] = ax;
    } else {
      const T lv = (ax - step.shift * centre) * step.inv_e;
      if constexpr (EPI == kStepZ) {
        y[k] = step.p * lv - step.q * step.z[k];
      } else {
        y[k] = step.p * lv;
      }
    }
    north = centre;
    centre = south;
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
