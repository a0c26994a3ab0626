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
// What bounds it on this card.  One multiply-add per 4 bytes of block data
// in float32 (8 in float64), so device-memory bandwidth at best: 3.35 TB/s
// needs about 20-25 KB of loads in flight on every SM (Little's law at
// ~1 us of latency).  Three things stand in the way: with few block-rows
// a CTA per block-row leaves most SMs without work; a CTA that walks its
// slots one by one starts each with dependent round trips (its column,
// then its x segment); and the TPU's padding (KB and nbr to multiples of
// 8) is bytes that carry no data.  What the design does about each:
//
//   - Slots split over a cluster.  The launch plan (ops/bsr.py::bsr_plan)
//     gives each block-row S CTAs (1 <= S <= 8), one thread-block cluster,
//     each summing a contiguous chunk of slots; S grows until about two
//     CTAs per SM run, so 8 block-rows fill the card as 512 do.  Each CTA
//     keeps its partial y segment in its own shared memory; after
//     cluster.sync() rank 0 reads the other ranks' partials through
//     distributed shared memory and adds them in rank order.  One launch,
//     no scratch in device memory, no atomics: the result is bitwise the
//     same from call to call.
//   - An asynchronous block stream.  A CTA's chunk is one contiguous run of
//     dataT.  One thread streams it through a ring of two shared-memory
//     stages with 1-D bulk async copies (cp.async.bulk, completing on an
//     mbarrier per stage).  On an H100 a CTA's stream rate follows the
//     bytes of one copy, not the number in flight, so the plan makes each
//     stage as large as the grid leaves room for (16-64 KB).  Blocks that
//     are not a multiple of 16 bytes (odd B) cannot use bulk copies; they
//     take a direct path in this same kernel: the stream is then not
//     16-byte aligned, so its loads are scalar ld.global.nc, eight
//     independent ones in flight per thread.
//   - x staged once.  Before the stream is consumed the CTA gathers the x
//     segments of all its slots into shared memory (one barrier), while the
//     first copies are already in flight: no round trip per slot.  A chunk
//     whose x segments pass the plan's window (32 KB) is staged window by
//     window.
//   - Threads read the stream as 16-byte vectors (direct path: scalars) in
//     a flat order.  Since threads * vector is a multiple of B, every vector
//     component of a thread meets one fixed output row i at every step, so
//     a thread keeps two sets of accumulators (even and odd steps) and the
//     threads sharing an i are summed by a pairwise tree in shared memory,
//     in a fixed order.  B = 8 uses every lane; B = 1024 needs no thread
//     per output row.
//   - Logical extents.  Only the real block-rows and slots are read; pad
//     block-rows of the packed operands are written as zeros.
//   - No tensor cores: one FMA per 4 (8) bytes is far below the ridge of
//     any tensor-core path, and wgmma would round float32 through TF32.
//     Sums stay in the input type with plain FMAs.
//   - Element offsets are 64-bit; y is written out of place.
// The C entries launch on the caller's stream, never synchronise, and
// return cudaGetLastError() (or the launch's own error) so a refused launch
// is reported.  The plan's fields are checked here again; a plan this
// kernel cannot run is refused with cudaErrorInvalidValue.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_B = 1024;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_STAGES = 8;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a block may use
constexpr size_t BAR_BYTES = 128;    // the stage mbarriers, ahead of the ring
constexpr int UNROLL = 8;            // direct path: loads in flight a thread

// The launch plan, as ops/bsr.py::bsr_plan computes it, with the operands'
// packed extents (strides) and logical extents (what is read).
struct Plan {
  int64_t nbr_p, kb_p, nbr_l, kb_l;
  int b;
  int S;            // CTAs per block-row: the cluster size
  int stage_elems;  // elements per tile (a ring stage on the bulk path)
  int nstages;      // ring stages; 0 on the direct path
  int xrows;        // rows (slot, j) of the x window in shared memory
};

__host__ __device__ inline size_t round16(size_t v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// Shared memory: barriers | ring | x window | per-thread partial sums.
// ops/bsr.py::bsr_plan computes the same sum.
template <typename T>
__host__ __device__ inline size_t smem_bytes(const Plan& p, int threads, int vec) {
  return BAR_BYTES + size_t(p.nstages) * p.stage_elems * sizeof(T) +
         round16(size_t(p.xrows) * sizeof(T)) + size_t(threads) * vec * sizeof(T);
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete.  A copy that never lands
// is a fault: after ~2^30 polls (seconds) the kernel traps, so the launch
// reports an error instead of holding the card.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared, completing `bytes` on `bar`.
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// One tile of the bulk path: thread tid's vectors at tid*V + m*step of the
// stage, rows qrow + qoff[v] + m*lanes of the x window.  Even and odd steps
// go to acc0 and acc1.  SAME: B % V == 0, so all components share a row.
template <typename T, int V, bool SAME>
__device__ inline void consume(const T* st, int n, int tid, int step,
                               const T* xs, int qrow, int lanes,
                               const int (&qoff)[V], T (&acc0)[V], T (&acc1)[V]) {
  int e = tid * V;
  for (; e + step < n; e += 2 * step, qrow += 2 * lanes) {
    const Pack<T, V> a = *reinterpret_cast<const Pack<T, V>*>(st + e);
    const Pack<T, V> c = *reinterpret_cast<const Pack<T, V>*>(st + e + step);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const T xa = xs[qrow + qoff[SAME ? 0 : v]];
      const T xc = xs[qrow + lanes + qoff[SAME ? 0 : v]];
      acc0[v] += a.v[v] * xa;
      acc1[v] += c.v[v] * xc;
    }
  }
  if (e < n) {
    const Pack<T, V> a = *reinterpret_cast<const Pack<T, V>*>(st + e);
#pragma unroll
    for (int v = 0; v < V; ++v) acc0[v] += a.v[v] * xs[qrow + qoff[SAME ? 0 : v]];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    bsr_kernel(const int32_t* __restrict__ cols, const T* __restrict__ dataT,
               const T* __restrict__ x, T* __restrict__ y, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* ring = reinterpret_cast<T*>(smem + BAR_BYTES);
  T* xs = ring + size_t(p.nstages) * p.stage_elems;
  T* part = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(xs) +
                                 round16(size_t(p.xrows) * sizeof(T)));

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b = p.b;
  const int64_t bb = int64_t(b) * b;
  const int rank = int(blockIdx.x % unsigned(p.S));  // cluster dims (S, 1, 1)
  const int64_t g = blockIdx.x / unsigned(p.S);      // this cluster's block-row
  const int64_t G = gridDim.x / unsigned(p.S);

  // Pad block-rows get zeros: cluster g writes rows g + G, g + 2G, ...
  // (all rows from g when there is no logical block-row).
  if (rank == 0) {
    for (int64_t r = g < p.nbr_l ? g + G : g; r < p.nbr_p; r += G)
      for (int i = tid; i < b; i += nthr) y[r * b + i] = T(0);
  }
  if (g >= p.nbr_l) return;  // the whole cluster: g is uniform in it

  // This CTA's chunk of slots, as bsr_plan's `chunks`.
  const int64_t k0 = rank * p.kb_l / p.S;
  const int64_t k1 = (rank + 1) * p.kb_l / p.S;
  const int64_t len = (k1 - k0) * bb;  // elements of the stream
  const int64_t rows = (k1 - k0) * b;  // its (slot, j) rows
  const T* src = dataT + (g * p.kb_p + k0) * bb;
  const int32_t* rcols = cols + g * p.kb_p + k0;
  const int se = p.stage_elems;
  const int64_t ntiles = (len + se - 1) / se;
  const int ns = p.nstages;

  auto issue = [&](int64_t c) {  // one thread: tile c into stage c % ns
    const int s = int(c % ns);
    const uint32_t bytes = uint32_t(imin(se, len - c * se) * sizeof(T));
    mbar_expect_tx(&bars[s], bytes);
    bulk_load(ring + size_t(s) * se, src + c * se, bytes, &bars[s]);
  };
  if constexpr (V > 1) {
    if (tid == 0) {
      for (int s = 0; s < ns; ++s) mbar_init(&bars[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int64_t c = 0; c < imin(ns, ntiles); ++c) issue(c);
    }
  }

  // Gather x for rows [w0, w0 + xrows) of the stream: row q is
  // x[cols[k0 + q / B] * B + q % B].
  auto stage_x = [&](int64_t w0) {
    const int64_t w1 = imin(rows, w0 + p.xrows);
    for (int64_t q = w0 + tid; q < w1; q += nthr) {
      const int64_t k = q / b;
      xs[q - w0] = __ldg(x + int64_t(__ldg(rcols + k)) * b + (q - k * b));
    }
  };
  stage_x(0);
  __syncthreads();  // x window and (bulk path) barrier initialisation

  // Flat mapping: component v of thread tid reads stream element
  // tid*V + v + m*nthr*V at step m; nthr*V % B == 0, so its output row is
  // i = (tid*V + v) % B at every step and its stream row advances by
  // lanes = nthr*V / B.
  const int lanes = nthr * V / b;
  int qoff[V];
#pragma unroll
  for (int v = 0; v < V; ++v) qoff[v] = (tid * V + v) / b;
  T acc0[V], acc1[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc0[v] = acc1[v] = T(0);

  const int tile_rows = se / b;
  int64_t w0 = 0;
  for (int64_t c = 0; c < ntiles; ++c) {
    const int64_t q0 = c * tile_rows;
    if (q0 + tile_rows > w0 + p.xrows) {  // past the window: the next one
      __syncthreads();
      w0 = q0;
      stage_x(w0);
      __syncthreads();
    }
    const int n = int(imin(se, len - c * se));
    const int qb = int(q0 - w0);
    if constexpr (V > 1) {
      mbar_wait(&bars[c % ns], uint32_t((c / ns) & 1));
      const T* st = ring + size_t(c % ns) * se;
      if (b % V == 0)
        consume<T, V, true>(st, n, tid, nthr * V, xs, qb, lanes, qoff, acc0, acc1);
      else
        consume<T, V, false>(st, n, tid, nthr * V, xs, qb, lanes, qoff, acc0, acc1);
      __syncthreads();  // every thread is done with stage c % ns
      if (tid == 0 && c + ns < ntiles) issue(c + ns);
    } else {
      const T* tile = src + c * se;
      int qrow = qb + qoff[0];
      for (int e = tid; e < n; e += nthr * UNROLL, qrow += UNROLL * lanes) {
        T d[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int idx = e + u * nthr;
          d[u] = idx < n ? __ldg(tile + idx) : T(0);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (e + u * nthr < n) {
            if (u & 1)
              acc1[0] += d[u] * xs[qrow + u * lanes];
            else
              acc0[0] += d[u] * xs[qrow + u * lanes];
          }
        }
      }
    }
  }

  // Sum the lanes sharing an output row: part[l*B + i] for l < lanes, by a
  // pairwise tree in a fixed order.
#pragma unroll
  for (int v = 0; v < V; ++v) part[tid * V + v] = acc0[v] + acc1[v];
  for (int live = lanes; live > 1;) {
    int half = 1;
    while (2 * half < live) half *= 2;
    __syncthreads();
    for (int e = tid; e < (live - half) * b; e += nthr) part[e] += part[e + half * b];
    live = half;
  }
  __syncthreads();

  if (p.S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's partial segment is final
    if (rank == 0) {
      for (int i = tid; i < b; i += nthr) {
        T s = part[i];
        for (int r = 1; r < p.S; ++r) s += cluster.map_shared_rank(part, r)[i];
        y[g * b + i] = s;
      }
    }
    cluster.sync();  // no rank exits while rank 0 reads its shared memory
  } else {
    for (int i = tid; i < b; i += nthr) y[g * b + i] = part[i];
  }
}

// Dynamic shared memory above 48 KB has to be allowed once per kernel and
// device.
template <typename T, int V>
cudaError_t allow_smem() {
  static std::mutex mu;
  static uint64_t done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && ((done >> dev) & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(bsr_kernel<T, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(MAX_SMEM));
  if (err == cudaSuccess && dev < 64) done |= uint64_t(1) << dev;
  return err;
}

template <typename T, int V>
int run(const void* cols, const void* dataT, const void* x, void* y,
        const Plan& p, int threads, size_t smem, void* stream) {
  cudaError_t err = allow_smem<T, V>();
  if (err != cudaSuccess) return int(err);
  const int64_t G = p.nbr_l > 0 ? p.nbr_l : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(G * p.S));
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bsr_kernel<T, V>,
                           static_cast<const int32_t*>(cols),
                           static_cast<const T*>(dataT),
                           static_cast<const T*>(x), static_cast<T*>(y), p);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* cols, const void* dataT, const void* x, void* y,
           int64_t nbr_p, int64_t kb_p, int64_t nbr_l, int64_t kb_l, int64_t b,
           int64_t S, int64_t threads, int64_t vec, int64_t stage_elems,
           int64_t nstages, int64_t xrows, void* stream) {
  constexpr int VB = int(16 / sizeof(T));
  const int invalid = int(cudaErrorInvalidValue);
  if (b < 1 || b > MAX_B || nbr_l < 0 || kb_l < 0 || nbr_l > nbr_p || kb_l > kb_p)
    return invalid;
  if (nbr_p == 0) return int(cudaSuccess);
  if (S < 1 || S > MAX_CLUSTER || S > (kb_l > 1 ? kb_l : 1)) return invalid;
  if (threads < 1 || threads > MAX_THREADS || (vec != 1 && vec != VB) ||
      (threads * vec) % b != 0)
    return invalid;
  // A stage's bytes must fit an mbarrier's transaction count (< 2^20).
  if (stage_elems < 1 || stage_elems % (threads * vec) != 0 ||
      stage_elems * int64_t(sizeof(T)) >= (1 << 20))
    return invalid;
  if (vec == VB) {
    if (nstages < 1 || nstages > MAX_STAGES || (b * b * int64_t(sizeof(T))) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(dataT) % 16 != 0)
      return invalid;
  } else if (nstages != 0) {
    return invalid;
  }
  const int64_t tile_rows = stage_elems / b;
  if (xrows < tile_rows || xrows % tile_rows != 0 || xrows > (1 << 20)) return invalid;
  const int64_t G = nbr_l > 0 ? nbr_l : 1;
  if (G * S > INT32_MAX) return int(cudaErrorInvalidConfiguration);
  const Plan p{nbr_p, kb_p, nbr_l, kb_l, int(b), int(S), int(stage_elems),
               int(nstages), int(xrows)};
  const size_t smem = smem_bytes<T>(p, int(threads), int(vec));
  if (smem > MAX_SMEM) return invalid;
  if (vec == VB)
    return run<T, VB>(cols, dataT, x, y, p, int(threads), smem, stream);
  return run<T, 1>(cols, dataT, x, y, p, int(threads), smem, stream);
}

}  // namespace

// nbr_p, kb_p: the packed extents of cols (nbr_p, kb_p) and dataT
// (nbr_p, kb_p, b, b); nbr_l, kb_l: the logical ones, the only block-rows
// and slots read (y rows past nbr_l * b are written as zeros).  The rest is
// ops/bsr.py::bsr_plan: S, threads, vec (16 / sizeof(T) for the bulk path,
// 1 for the direct one), stage_elems, nstages, xrows.
extern "C" int bsr_f32(const void* cols, const void* dataT, const void* x,
                       void* y, int64_t nbr_p, int64_t kb_p, int64_t nbr_l,
                       int64_t kb_l, int64_t b, int64_t S, int64_t threads,
                       int64_t vec, int64_t stage_elems, int64_t nstages,
                       int64_t xrows, void* stream) {
  return launch<float>(cols, dataT, x, y, nbr_p, kb_p, nbr_l, kb_l, b, S,
                       threads, vec, stage_elems, nstages, xrows, stream);
}

extern "C" int bsr_f64(const void* cols, const void* dataT, const void* x,
                       void* y, int64_t nbr_p, int64_t kb_p, int64_t nbr_l,
                       int64_t kb_l, int64_t b, int64_t S, int64_t threads,
                       int64_t vec, int64_t stage_elems, int64_t nstages,
                       int64_t xrows, void* stream) {
  return launch<double>(cols, dataT, x, y, nbr_p, kb_p, nbr_l, kb_l, b, S,
                        threads, vec, stage_elems, nstages, xrows, stream);
}
