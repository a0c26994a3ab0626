// Block-sparse row (block-level ELL) matvec y = A x for NVIDIA Hopper
// (sm_90a).  Block-row r holds KB dense (B, B) blocks, slot k at block
// column cols[r, k]; the blocks are stored TRANSPOSED,
//
//   dataT[r, k, j, i] = A_block(r, k)[i, j],
//
// so y[r*B + i] = sum_k sum_j dataT[r, k, j, i] * x[cols[r, k]*B + j].
//
// Replaces the TPU kernel of arnoldimethod_tpu/ops/bsr_pallas.py,
// `bsr_matvec` (_kernel), which contracts a lane-concatenated row of x
// segments against the transposed block slab on the MXU.  The same packed
// operands (pack_bsr) feed this kernel unchanged.
//
// Bound: memory.  Each stored block entry is read once for one
// multiply-add (4 bytes per FMA in float32, 8 in float64); x segments are
// re-read by every block-row that references them, mostly from L2, and y
// is written once.  Design:
//   - one CTA per block-row r, one thread per output row i (blockDim is B
//     rounded up to a warp, at most 1024), so no two CTAs write the same y
//     entries and no atomics are needed;
//   - for each slot k the CTA stages the B-long x segment in shared memory,
//     then thread i walks j over the block: the transposed layout puts
//     dataT[r, k, j, i] for consecutive i at consecutive addresses, so
//     every (k, j) step of a warp is one coalesced load of the block data;
//   - the j loop is unrolled so several independent loads are in flight
//     per thread;
//   - the sum is kept in the input type (float32 or float64), with plain
//     FMAs and no tensor cores, so no TF32 rounding enters;
//   - pad slots (block column 0, zero data) add zero, duplicate columns
//     add their blocks; any nbr, KB and B <= 1024 are taken, nothing
//     depends on pack_bsr's padding;
//   - element offsets are 64-bit (the block data passes 2^31 elements at
//     realistic sizes);
//   - y is written out of place.
// The C entries launch on the caller's stream, never synchronise, and
// return cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int MAX_B = 1024;

template <typename T>
__global__ void __launch_bounds__(MAX_B)
bsr_kernel(const int32_t* __restrict__ cols, const T* __restrict__ dataT,
           const T* __restrict__ x, T* __restrict__ y, int64_t kb, int b) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int64_t r = blockIdx.x;
  const int i = threadIdx.x;
  const int32_t* rcols = cols + r * kb;
  const int64_t bb = int64_t(b) * b;
  const T* rdata = dataT + r * kb * bb;
  T acc = T(0);
  for (int64_t k = 0; k < kb; ++k) {
    const int64_t c = rcols[k];
    __syncthreads();  // every thread is done with the previous segment
    for (int j = i; j < b; j += blockDim.x) xs[j] = __ldg(x + c * b + j);
    __syncthreads();
    if (i < b) {
      const T* col = rdata + k * bb + i;
#pragma unroll 8
      for (int j = 0; j < b; ++j) acc += __ldg(col + int64_t(j) * b) * xs[j];
    }
  }
  if (i < b) y[r * b + i] = acc;
}

template <typename T>
int launch(const void* cols, const void* dataT, const void* x, void* y,
           int64_t nbr, int64_t kb, int64_t b, void* stream) {
  if (nbr < 0 || kb < 0 || b < 1 || b > MAX_B) return int(cudaErrorInvalidValue);
  if (nbr > INT32_MAX) return int(cudaErrorInvalidConfiguration);
  if (nbr == 0) return int(cudaSuccess);
  const int threads = int((b + 31) / 32 * 32);
  const size_t smem = size_t(b) * sizeof(T);
  bsr_kernel<T><<<dim3(unsigned(nbr)), dim3(threads), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(dataT),
      static_cast<const T*>(x), static_cast<T*>(y), kb, int(b));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int bsr_f32(const void* cols, const void* dataT, const void* x,
                       void* y, int64_t nbr, int64_t kb, int64_t b,
                       void* stream) {
  return launch<float>(cols, dataT, x, y, nbr, kb, b, stream);
}

extern "C" int bsr_f64(const void* cols, const void* dataT, const void* x,
                       void* y, int64_t nbr, int64_t kb, int64_t b,
                       void* stream) {
  return launch<double>(cols, dataT, x, y, nbr, kb, b, stream);
}
