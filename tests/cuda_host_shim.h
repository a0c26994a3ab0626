// The CUDA features arnoldimethod_torch/csrc/df.cu's, dense_restart.cu's and
// stencil5.cu's kernels use, emulated on the host so that their source runs
// on a CPU (tests/test_torch_df_source.py,
// tests/test_torch_dense_restart_source.py,
// tests/test_torch_stencil_source.py):
// one std::thread per CUDA thread, the blocks of a launch one after
// another, __syncthreads as a std::barrier, shared memory as statics (the
// dynamic buffer as one host array), cp.async as a copy that has landed
// when it returns, atomicAdd under a mutex, a spin-wait's pause as a
// yield, clock64 as a host clock, and
// __syncwarp and the shuffles through a slot a lane and a barrier a warp
// (every lane of the warp's threads takes part, as every shuffle and
// __syncwarp in those files does).  Each rounded intrinsic is one IEEE
// operation (the tests build with -ffp-contract=off).
#pragma once
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
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
// A barrier and 32 exchange slots of 8 bytes for each warp of the block.
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
alignas(8) inline unsigned char emu_lane_slots[32][32][8];
inline std::mutex emu_atomic_mutex;
alignas(16) inline unsigned char emu_dynamic_shared[256 * 1024];

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
// The host buffer holds any size a block may ask for.
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// Blocks run one at a time here.
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int,
                                                          size_t) {
  *blocks = 1;
  return cudaSuccess;
}

inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline double __ddiv_rn(double a, double b) { volatile double r = a / b; return r; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __fsqrt_rn(float a) { volatile float r = std::sqrt(a); return r; }
inline double __dsqrt_rn(double a) { volatile double r = std::sqrt(a); return r; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
template <class T> void __stcg(T* p, T v) { *p = v; }
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline void __threadfence() {}
// A spin-wait yields the core.
#define SPIN_PAUSE() std::this_thread::yield()
#define IDLE_PAUSE() std::this_thread::yield()
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> hold(emu_atomic_mutex);
  const unsigned old = *p;
  *p = old + v;
  return old;
}
// Lane l gets lane l + delta's value, its own where that lane is past the
// warp's threads.
template <class T> T __shfl_down_sync(unsigned, T v, int delta) {
  static_assert(sizeof(T) <= 8, "a shuffled value fits a slot");
  const unsigned t = threadIdx.x, w = t / 32, lane = t % 32;
  const unsigned width = blockDim.x - w * 32 < 32 ? blockDim.x - w * 32 : 32;
  std::barrier<>& bar = *emu_warp_barriers[w];
  std::memcpy(emu_lane_slots[w][lane], &v, sizeof(T));
  bar.arrive_and_wait();
  T out = v;
  if (lane + delta < width)
    std::memcpy(&out, emu_lane_slots[w][lane + delta], sizeof(T));
  bar.arrive_and_wait();  // every lane has read before the slots are reused
  return out;
}
// Lane l gets lane `src`'s value (`src` below the warp's threads).
template <class T> T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= 8, "a shuffled value fits a slot");
  const unsigned t = threadIdx.x, w = t / 32, lane = t % 32;
  std::barrier<>& bar = *emu_warp_barriers[w];
  std::memcpy(emu_lane_slots[w][lane], &v, sizeof(T));
  bar.arrive_and_wait();
  T out;
  std::memcpy(&out, emu_lane_slots[w][src], sizeof(T));
  bar.arrive_and_wait();
  return out;
}
// Lane l gets lane l ^ mask's value, its own where that lane is past the
// warp's threads.
template <class T> T __shfl_xor_sync(unsigned, T v, int mask) {
  static_assert(sizeof(T) <= 8, "a shuffled value fits a slot");
  const unsigned t = threadIdx.x, w = t / 32, lane = t % 32;
  const unsigned width = blockDim.x - w * 32 < 32 ? blockDim.x - w * 32 : 32;
  std::barrier<>& bar = *emu_warp_barriers[w];
  std::memcpy(emu_lane_slots[w][lane], &v, sizeof(T));
  bar.arrive_and_wait();
  T out = v;
  if ((lane ^ unsigned(mask)) < width)
    std::memcpy(&out, emu_lane_slots[w][lane ^ unsigned(mask)], sizeof(T));
  bar.arrive_and_wait();
  return out;
}
// Every lane of the warp's threads takes part.
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
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
      emu_warp_barriers.clear();
      for (unsigned w = 0; w * 32 < block.x; ++w)
        emu_warp_barriers.push_back(std::make_unique<std::barrier<>>(
            block.x - w * 32 < 32 ? block.x - w * 32 : 32));
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, t] {
          threadIdx = {t, 0, 0};
          f();
          // An exited thread leaves its block's and its warp's barriers.
          bar.arrive_and_drop();
          emu_warp_barriers[t / 32]->arrive_and_drop();
        });
      for (auto& th : threads) th.join();
    }
}
