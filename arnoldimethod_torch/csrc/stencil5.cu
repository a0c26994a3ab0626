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
// The C entries launch on the caller's stream, never synchronise, and
// return cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE_COLS = 128;  // threads per block, one column each

template <typename T>
__global__ void __launch_bounds__(TILE_COLS)
stencil5_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t ny,
                int64_t nx, int64_t col_blocks, int64_t tile_rows, T c, T w,
                T e, T n, T s) {
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
    y[k] = c * centre + w * west + e * east + n * north + s * south;
    north = centre;
    centre = south;
  }
}

template <typename T>
int launch(const void* x, void* y, int64_t ny, int64_t nx, double c,
           double w, double e, double n, double s, int64_t tile_rows,
           void* stream) {
  if (ny <= 0 || nx <= 0 || tile_rows <= 0) return int(cudaErrorInvalidValue);
  const int64_t col_blocks = (nx + TILE_COLS - 1) / TILE_COLS;
  const int64_t row_blocks = (ny + tile_rows - 1) / tile_rows;
  const int64_t blocks = col_blocks * row_blocks;
  if (blocks > INT32_MAX) return int(cudaErrorInvalidConfiguration);
  stencil5_kernel<T><<<dim3(unsigned(blocks)), dim3(TILE_COLS), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), ny, nx, col_blocks,
      tile_rows, T(c), T(w), T(e), T(n), T(s));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int stencil5_f32(const void* x, void* y, int64_t ny, int64_t nx,
                            double c, double w, double e, double n, double s,
                            int64_t tile_rows, void* stream) {
  return launch<float>(x, y, ny, nx, c, w, e, n, s, tile_rows, stream);
}

extern "C" int stencil5_f64(const void* x, void* y, int64_t ny, int64_t nx,
                            double c, double w, double e, double n, double s,
                            int64_t tile_rows, void* stream) {
  return launch<double>(x, y, ny, nx, c, w, e, n, s, tile_rows, stream);
}
