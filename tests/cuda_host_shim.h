// The CUDA features arnoldimethod_torch/csrc/df.cu's basis-change and
// stencil kernels use, emulated on the host so that their source runs on a
// CPU (tests/test_torch_df_source.py): one std::thread per CUDA thread,
// the blocks of a launch one after another, __syncthreads as a
// std::barrier, shared memory as statics, cp.async as a copy that has
// landed when it returns.  Each rounded intrinsic is one IEEE operation
// (the test builds with -ffp-contract=off).  Not emulated: warp shuffles
// and atomics (df_project), which abort.
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 {
  unsigned x, y, z;
};
inline thread_local emu_uint3 threadIdx;
inline emu_uint3 blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
alignas(16) inline unsigned char emu_dynamic_shared[256 * 1024];

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
template <class T> void __stcg(T* p, T v) { *p = v; }
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline void __threadfence() {}
inline unsigned atomicAdd(unsigned*, unsigned) { std::abort(); }
template <class T> T __shfl_down_sync(unsigned, T, int) { std::abort(); }
inline size_t __cvta_generic_to_shared(const void*) { return 0; }
template <class T> T min(T a, T b) { return a < b ? a : b; }

// cp.async with src_bytes below the copy's size: zero-fill the rest.
inline void emu_copy(void* dst, const void* src, int size, int src_bytes) {
  std::memcpy(dst, src, src_bytes);
  std::memset(static_cast<char*>(dst) + src_bytes, 0, size - src_bytes);
}

// kernel<<<grid, block, ...>>>(args) becomes emu_launch(grid, block, f).
template <class F>
void emu_launch(dim3 grid, dim3 block, F f) {
  gridDim = grid;
  blockDim = block;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = {bx, by, 0};
      std::barrier<> bar(block.x);
      emu_barrier = &bar;
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, t] {
          threadIdx = {t, 0, 0};
          f();
          bar.arrive_and_drop();  // an exited thread leaves the barrier
        });
      for (auto& th : threads) th.join();
    }
}
