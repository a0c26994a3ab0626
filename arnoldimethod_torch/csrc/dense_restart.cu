// The dense restart of method="device" as two CUDA kernels, for float and
// double: `restart_kernel` runs one restart's dense phase (the body of the
// JAX package's fused loop, arnoldimethod_tpu/fused.py:109-202, from
// local_schur through Qbig) and `finish_kernel` the final sort
// (_fused_finish, :221-232).
//
// What it replaces: no Pallas kernel.  In the JAX package this work is XLA
// code, the lax.while_loop body of fused.py over the functions of
// arnoldimethod_tpu/dense/device.py.  Its loops branch on data at every
// deflation check, shift choice, swap and group decision; as plain torch on
// CUDA tensors each branch would be a host read, hundreds of them a
// restart.  Here the whole restart is one launch and the host reads only
// the int32 state afterwards.
//
// What bounds it: a dependent chain on one small matrix.  The Francis bulge
// chase, the swaps and the Givens pass of the restore are sequences of
// rotations in which each one reads what the last one wrote (~5,900 steps
// a restart at m = 80, ~30,000 at m = 200), so the kernel runs on one CTA
// and its time is the chain's latency.  The design:
// - H ((m+1) x m) and Q (m x m) live in dynamic shared memory for the whole
//   launch, rows at an odd stride so that a column walk hits 32 banks;
//   copied in at entry, written back (and Qbig built) at exit.  Where they
//   do not fit (float above m = 168, double above m = 118) the same code
//   runs on them in global memory; the wrapper picks the storage.
// - Every rotation runs on one warp, the chain warp (warp 0): the lanes
//   split the row or column range (<= 3 elements a lane at m = 80), every
//   lane computes the scalar decisions (rotations, shifts, deflation, the
//   case switches, the <= 4 x 4 complete-pivot Sylvester solves, unrolled
//   into registers) from the same data, so nothing is broadcast, and
//   dependent applications are separated by __syncwarp().
// - Where the caller asks for the helper (`helper`), the updates the chain
//   does not read again (Q's, and a sweep's rows of H above the bulge) go
//   through a ring in shared memory to warp 1, which applies them in the
//   chain's order; otherwise the chain applies them itself.  The other
//   warps wait at the next block barrier.
// - The block-wide phases (eigenvalues, residuals, the sort, the
//   Householder sweeps of the restore, Qbig) use every warp; their sums
//   run a warp a row, the tree in registers and shuffles.
//
// Arithmetic: every operation is the plain version's
// (arnoldimethod_torch/dense/device.py) in the same order, so the branches
// follow it: the kernel is compiled with --fmad=false (no contraction),
// every sum is tree_sum's fixed pairwise tree (zero-padded to a power of
// two, x[i] += x[i + h] for h = P/2 .. 1), and hypot is JAX's formula.
//
// Measurement: thread 0 writes clock64() stamps at the phase boundaries
// when the wrapper passes a buffer (null: no stamps), and the chain warp
// counts its Francis sweeps and rotation steps in registers, written into
// `info` at the end.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double vsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float vabs(float x) { return fabsf(x); }
__device__ __forceinline__ double vabs(double x) { return fabs(x); }
__device__ __forceinline__ float vcopysign(float x, float y) { return copysignf(x, y); }
__device__ __forceinline__ double vcopysign(double x, double y) { return copysign(x, y); }

// Python's max(a, b) and min(a, b): the first argument unless the second
// is strictly larger (smaller).
template <class T> __device__ __forceinline__ T pmax(T a, T b) { return b > a ? b : a; }
template <class T> __device__ __forceinline__ T pmin(T a, T b) { return b < a ? b : a; }
template <class T> __device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Threads of a launch at most, and the largest m: a warp sum holds at
// most 32 slots a lane.
constexpr int MAX_THREADS = 256;
constexpr int MAX_M = 1023;

#define TID static_cast<int>(threadIdx.x)
#define NT static_cast<int>(blockDim.x)
#define SYNC() __syncthreads()
// A thread's lane; in the chain functions, the chain warp's lanes.
#define LANE (static_cast<int>(threadIdx.x) & 31)
#define WSYNC() __syncwarp()
constexpr unsigned FULL = 0xffffffffu;

// f(r, c) over a rows x cols range, block-wide: a warp a row, the lanes
// along it.
template <class F>
__device__ __forceinline__ void block_rows(int rows, int cols, const F& f) {
  for (int r = TID / 32; r < rows; r += NT / 32)
    for (int c = LANE; c < cols; c += 32) f(r, c);
}

// --- reductions ----------------------------------------------------------------

// Every thread gets the minimum of the block's values.
__device__ __forceinline__ int block_min(int v) {
  __shared__ int red[MAX_THREADS / 32];
  for (int off = 16; off > 0; off /= 2) v = imin(v, __shfl_xor_sync(FULL, v, off));
  if (LANE == 0) red[TID / 32] = v;
  SYNC();
  int r = red[0];
  for (int w = 1; w * 32 < NT; ++w) r = imin(r, red[w]);
  SYNC();
  return r;
}

// Every lane of a warp gets the maximum of the warp's values.
__device__ __forceinline__ int warp_max(int v) {
  for (int off = 16; off > 0; off /= 2) v = imax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// s[0] = tree_sum(s[0:n]) over the block: s has P = pow2_at_least(n) slots,
// the caller filled s[0:n] and synchronized.  Every thread returns s[0].
template <class T>
__device__ __forceinline__ T block_tree(T* s, int n) {
  const int P = pow2_at_least(n);
  for (int i = n + TID; i < P; i += NT) s[i] = T(0);
  SYNC();
  for (int h = P / 2; h >= 1; h /= 2) {
    for (int i = TID; i < h; i += NT) s[i] = s[i] + s[i + h];
    SYNC();
  }
  const T r = s[0];
  SYNC();
  return r;
}

// Slot k of a lane's K slots (slot k: element LANE + 32 k) after the
// tree's steps down to h, x[k] += x[k + h]; h = K is the element itself.
// Depth first, so that only log2 K partial sums are live.
template <class T, int K, int h, class F>
__device__ __forceinline__ T lane_slot(int k, int n, const F& f) {
  if constexpr (h == K) {
    const int c = LANE + 32 * k;
    return c < n ? f(c) : T(0);
  } else {
    return lane_slot<T, K, 2 * h>(k, n, f) + lane_slot<T, K, 2 * h>(k + h, n, f);
  }
}

// tree_sum of f(0), ..., f(n-1) by one warp, P = 32 K slots: lane l holds
// slots l, l + 32, ...; the steps h >= 32 run in its registers, then
// shuffles take h = 16 .. 1.  The same order as tree_sum; lane 0's result.
template <class T, int K, class F>
__device__ __forceinline__ T warp_tree_k(int n, const F& f) {
  T r = lane_slot<T, K, 1>(0, n, f);
  for (int h = 16; h >= 1; h /= 2) r = r + __shfl_down_sync(FULL, r, h);
  return r;
}

template <class T, class F>
__device__ __forceinline__ T warp_tree(int n, const F& f) {
  const int P = pow2_at_least(n);
  if (P <= 32) {
    T r = LANE < n ? f(LANE) : T(0);
    for (int h = P / 2; h >= 1; h /= 2) r = r + __shfl_down_sync(FULL, r, h);
    return r;
  }
  switch (P / 32) {
    case 2: return warp_tree_k<T, 2>(n, f);
    case 4: return warp_tree_k<T, 4>(n, f);
    case 8: return warp_tree_k<T, 8>(n, f);
    case 16: return warp_tree_k<T, 16>(n, f);
    default: return warp_tree_k<T, 32>(n, f);
  }
}

// --- Givens rotations, by the chain warp -------------------------------------------

template <class T>
__device__ __forceinline__ T hyp(T x, T y) {
  const T a = vabs(x), b = vabs(y);
  const T hi = pmax(a, b), lo = pmin(a, b);
  if (hi == T(0)) return hi;
  const T q = lo / hi;
  return hi * vsqrt(T(1) + q * q);
}

template <class T>
__device__ __forceinline__ void givens(T f, T g, T& c, T& s, T& r) {
  if (g == T(0)) { c = T(1); s = T(0); r = f; return; }
  if (f == T(0)) { c = T(0); s = g < T(0) ? T(-1) : T(1); r = vabs(g); return; }
  const T scale = pmax(vabs(f), vabs(g));
  const T fs = f / scale, gs = g / scale;
  const T d = vsqrt(fs * fs + gs * gs);
  const T sg = f < T(0) ? T(-1) : T(1);
  c = vabs(fs) / d;
  s = sg * gs / d;
  r = sg * d * scale;
}

// The row and column updates: the lanes along the range, each lane
// loading its next U elements before it computes and stores them, so that
// one memory latency covers them (U = 1 in shared memory, 4 in global).

// A[i:i+2, j0:j1] = [c s; -s c] @ A[i:i+2, j0:j1] (row stride ld).
template <int U, class T>
__device__ __forceinline__ void lmul2(T* A, int ld, T c, T s, int i, int j0, int j1) {
  T* r1 = A + i * ld;
  T* r2 = r1 + ld;
  for (int j = j0 + LANE; j < j1; j += 32 * U) {
    T a1[U] = {}, a2[U] = {};
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + 32 * u < j1) {
        a1[u] = r1[j + 32 * u];
        a2[u] = r2[j + 32 * u];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + 32 * u < j1) {
        r1[j + 32 * u] = c * a1[u] + s * a2[u];
        r2[j + 32 * u] = -s * a1[u] + c * a2[u];
      }
  }
}

// A[r0:r1, i:i+2] = A[r0:r1, i:i+2] @ [c s; -s c]^T.
template <int U, class T>
__device__ __forceinline__ void rmul2(T* A, int ld, T c, T s, int i, int r0, int r1) {
  for (int r = r0 + LANE; r < r1; r += 32 * U) {
    T a1[U] = {}, a2[U] = {};
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + 32 * u < r1) {
        const T* a = A + (r + 32 * u) * ld + i;
        a1[u] = a[0];
        a2[u] = a[1];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + 32 * u < r1) {
        T* a = A + (r + 32 * u) * ld + i;
        a[0] = a1[u] * c + a2[u] * s;
        a[1] = -a1[u] * s + a2[u] * c;
      }
  }
}

template <int U, class T>
__device__ __forceinline__ void lmul3(T* A, int ld, T c1, T s1, T c2, T s2, int i, int j0,
                                      int j1) {
  T* q1 = A + i * ld;
  T* q2 = q1 + ld;
  T* q3 = q2 + ld;
  for (int j = j0 + LANE; j < j1; j += 32 * U) {
    T a1[U] = {}, a2[U] = {}, a3[U] = {};
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + 32 * u < j1) {
        a1[u] = q1[j + 32 * u];
        a2[u] = q2[j + 32 * u];
        a3[u] = q3[j + 32 * u];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + 32 * u < j1) {
        const T b2 = c1 * a2[u] + s1 * a3[u];
        const T b3 = -s1 * a2[u] + c1 * a3[u];
        q1[j + 32 * u] = c2 * a1[u] + s2 * b2;
        q2[j + 32 * u] = -s2 * a1[u] + c2 * b2;
        q3[j + 32 * u] = b3;
      }
  }
}

template <int U, class T>
__device__ __forceinline__ void rmul3(T* A, int ld, T c1, T s1, T c2, T s2, int i, int r0,
                                      int r1) {
  for (int r = r0 + LANE; r < r1; r += 32 * U) {
    T a1[U] = {}, a2[U] = {}, a3[U] = {};
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + 32 * u < r1) {
        const T* a = A + (r + 32 * u) * ld + i;
        a1[u] = a[0];
        a2[u] = a[1];
        a3[u] = a[2];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + 32 * u < r1) {
        T* a = A + (r + 32 * u) * ld + i;
        const T b2 = a2[u] * c1 + a3[u] * s1;
        const T b3 = -a2[u] * s1 + a3[u] * c1;
        a[0] = a1[u] * c2 + b2 * s2;
        a[1] = -a1[u] * s2 + b2 * c2;
        a[2] = b3;
      }
  }
}

// --- Francis QR's scalar decisions -------------------------------------------------

template <class T>
__device__ __forceinline__ void upper_triangular_2x2(T h11, T h12, T h21, T h22,
                                                     bool& is_real, T& c, T& s) {
  const bool trivially_pair = h21 == T(0) || (h11 == h22 && sgn(h12) != sgn(h21));
  if (trivially_pair) { is_real = false; c = T(1); s = T(0); return; }
  if (h12 == T(0)) { is_real = true; c = T(0); s = T(1); return; }
  const T p = (h11 - h22) / T(2);
  const T bcmax = pmax(vabs(h12), vabs(h21));
  const T bcmis = pmin(vabs(h12), vabs(h21)) * sgn(h12) * sgn(h21);
  const T scale = pmax(vabs(p), bcmax);
  const T scale_s = scale == T(0) ? T(1) : scale;
  const T z = (p / scale_s) * p + (bcmax / scale_s) * bcmis;
  if (z < T(0)) { is_real = false; c = T(1); s = T(0); return; }
  const T h11ml = p + vcopysign(vsqrt(scale) * vsqrt(pmax(z, T(0))), p);
  const T nrm = hyp(h21, h11ml);
  const T nrm_s = nrm == T(0) ? T(1) : nrm;
  is_real = true;
  c = h11ml / nrm_s;
  s = h21 / nrm_s;
}

template <class T>
__device__ __forceinline__ bool use_single_shift(T h11, T h12, T h21, T h22, T& mu) {
  const T scale = vabs(h11) + vabs(h12) + vabs(h21) + vabs(h22);
  const T scale_s = scale == T(0) ? T(1) : scale;
  const T a11 = h11 / scale_s, a12 = h12 / scale_s;
  const T a21 = h21 / scale_s, a22 = h22 / scale_s;
  const T tr = (a11 + a22) / T(2);
  const T d = (a11 - tr) * (a22 - tr) - a12 * a21;
  const T sq = vsqrt(vabs(d));
  const T lam1 = tr + sq, lam2 = tr - sq;
  const T lam = vabs(a22 - lam1) < vabs(a22 - lam2) ? lam1 : lam2;
  mu = lam * scale;
  return d <= T(0);
}

template <class T>
__device__ __forceinline__ void rot3(T p1, T p2, T p3, T& c1, T& s1, T& c2, T& s2,
                                     T& n2) {
  T n1;
  givens(p2, p3, c1, s1, n1);
  givens(p1, n1, c2, s2, n2);
}

// --- the sweep's ring: the chain's rotations for the helper warp ------------------

// During local_schur and the partition the chain warp publishes each
// rotation in a ring in shared memory and applies it itself only where the
// chain reads again.  The helper warp (warp 1) applies it to Q, which
// neither phase reads, and in a Francis sweep to H's rows above the step,
// which nothing reads again within the sweep; each element sees the
// rotations in the chain's order.  The chain waits for the helper at the
// end of each sweep.  (On an H100, more helpers splitting Q's rows were
// slower, their polling delaying the chain, and so was a third warp taking
// the sweep's H updates while the chain only computed rotations: a round
// trip between two warps costs more than the updates it moves.)  A launch
// of one warp applies everything in the chain.
constexpr int RING = 32;
enum { R_STOP = 0, R_TWO = 2, R_THREE = 3 };

// An entry: the rotation's kind and coefficients, its first column, and
// the rows [0, hend) of H the helper applies it to.
template <class T>
struct Ring {
  T c1[RING], s1[RING], c2[RING], s2[RING];
  int col[RING], hend[RING], kind[RING];
  int head;  // entries published
  int tail;  // entries applied
};

// The ring's handshake: a release store and an acquire load at block
// scope on shared memory (a fence would order more, and cost more), and
// the pause of a spin-wait: nothing on the card where the wait is on the
// chain's path, a short sleep in the helper's idle poll (the tests' host
// build yields in both).
__device__ __forceinline__ void store_release(int& x, int v) {
#ifdef __CUDA_ARCH__
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(&x));
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
#else
  __atomic_store_n(&x, v, __ATOMIC_RELEASE);
#endif
}
__device__ __forceinline__ int load_acquire(const int& x) {
#ifdef __CUDA_ARCH__
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(&x));
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
#else
  return __atomic_load_n(&x, __ATOMIC_ACQUIRE);
#endif
}
#ifndef SPIN_PAUSE
#define SPIN_PAUSE()
#define IDLE_PAUSE() __nanosleep(100)
#endif

// Lane 0 of the chain: wait until the helper's count (`tail`) reaches
// `upto`; returns it.
__device__ __forceinline__ int wait_tail(const int& tail, int upto) {
  int t = load_acquire(tail);
  while (t < upto) {
    SPIN_PAUSE();
    t = load_acquire(tail);
  }
  return t;
}

// The chain's side of the ring: whether a helper takes the published
// rotations (`off`), the entries published, and (lane 0) the count it may
// reach before it reads the helper's tail again.  It also carries the
// launch's Francis sweeps and rotation steps (one step: one left
// application of a two- or three-row rotation, with its right ones), in
// every chain lane's registers; thread 0 writes them out at the end.
template <class T>
struct Link {
  Ring<T>& ring;
  bool off;
  int head;
  int limit;
  int sweeps;
  int steps;
};

template <class T>
__device__ __forceinline__ void publish(Link<T>& l, int kind, int col, int hend, T c1,
                                        T s1, T c2, T s2) {
  Ring<T>& ring = l.ring;
  if (LANE == 0) {
    if (l.head >= l.limit) l.limit = wait_tail(ring.tail, l.head - RING + 1) + RING;
    const int k = l.head % RING;
    ring.c1[k] = c1;
    ring.s1[k] = s1;
    ring.c2[k] = c2;
    ring.s2[k] = s2;
    ring.col[k] = col;
    ring.hend[k] = hend;
    ring.kind[k] = kind;
    store_release(ring.head, l.head + 1);
  }
  ++l.head;
}

// The chain at the end of a sweep: every published rotation applied.
template <class T>
__device__ __forceinline__ void join(Link<T>& l) {
  if (LANE == 0) wait_tail(l.ring.tail, l.head);
  WSYNC();
}

// The end of a phase that publishes: the helper leaves `help`.
template <class T>
__device__ __forceinline__ void stop(Link<T>& l) {
  if (l.off) publish(l, R_STOP, 0, 0, T(0), T(0), T(0), T(0));
}

// The helper warp: apply the published rotations in order until the stop
// (the block synchronized since its last stop).
template <int U, class T>
__device__ __forceinline__ void help(T* H, T* Q, int m, int ld, Ring<T>& ring) {
  for (int next = ring.tail;; ++next) {
    if (LANE == 0)
      while (load_acquire(ring.head) <= next) IDLE_PAUSE();
    WSYNC();
    const int k = next % RING;
    const int kind = ring.kind[k];
    if (kind == R_STOP) {
      if (LANE == 0) ring.tail = next + 1;
      break;
    }
    const int i = ring.col[k], hend = ring.hend[k];
    const T c1 = ring.c1[k], s1 = ring.s1[k];
    if (kind == R_TWO) {
      rmul2<U>(H, ld, c1, s1, i, 0, hend);
      rmul2<U>(Q, ld, c1, s1, i, 0, m);
    } else {
      const T c2 = ring.c2[k], s2 = ring.s2[k];
      rmul3<U>(H, ld, c1, s1, c2, s2, i, 0, hend);
      rmul3<U>(Q, ld, c1, s1, c2, s2, i, 0, m);
    }
    WSYNC();
    if (LANE == 0) store_release(ring.tail, next + 1);
  }
}

// --- Francis QR (real quasi-Schur), by the chain warp ------------------------------

// One step of a sweep: the left rotation of rows i.. (cols i..m), the right
// one of H's rows ..r1 (cols i..) and of Q, then the scalars of column i-1
// (none at the first step).  With a helper (`off`) the step is published
// and the chain keeps H's rows from i; the right rotation waits for the
// left.
template <int U, class T>
__device__ __forceinline__ void step2(T* H, T* Q, int m, int ld, Link<T>& l, T c, T s,
                                      T r, int i, int r1, bool first) {
  const bool off = l.off;
  if (off) publish(l, R_TWO, i, i, c, s, T(0), T(0));
  lmul2<U>(H, ld, c, s, i, i, m);
  if (!off) rmul2<U>(Q, ld, c, s, i, 0, m);
  WSYNC();
  rmul2<U>(H, ld, c, s, i, off ? i : 0, r1);
  if (!first && LANE == 0) {
    H[i * ld + i - 1] = r;
    H[(i + 1) * ld + i - 1] = T(0);
  }
  WSYNC();
}

template <int U, class T>
__device__ __forceinline__ void step3(T* H, T* Q, int m, int ld, Link<T>& l, T c1, T s1,
                                      T c2, T s2, T r, int i, bool first) {
  const bool off = l.off;
  if (off) publish(l, R_THREE, i, i, c1, s1, c2, s2);
  lmul3<U>(H, ld, c1, s1, c2, s2, i, i, m);
  if (!off) rmul3<U>(Q, ld, c1, s1, c2, s2, i, 0, m);
  WSYNC();
  rmul3<U>(H, ld, c1, s1, c2, s2, i, off ? i : 0, imin(i + 4, m));
  if (!first && LANE == 0) {
    H[i * ld + i - 1] = r;
    H[(i + 1) * ld + i - 1] = T(0);
    H[(i + 2) * ld + i - 1] = T(0);
  }
  WSYNC();
}

// The chase's steps after the first read column i-1, which the left
// rotation does not touch, so the scalar writes of that column wait for
// the second phase and one __syncwarp suffices before it.
template <int U, class T>
__device__ __forceinline__ void single_shift_sweep(T* H, T* Q, int m, int ld, Link<T>& l,
                                                   int frm, int to, T mu) {
  T c, s, r;
  givens(H[frm * ld + frm] - mu, H[(frm + 1) * ld + frm], c, s, r);
  WSYNC();
  step2<U>(H, Q, m, ld, l, c, s, r, frm, imin(frm + 3, m), true);
  for (int i = frm + 1; i < to; ++i) {
    givens(H[i * ld + i - 1], H[(i + 1) * ld + i - 1], c, s, r);
    step2<U>(H, Q, m, ld, l, c, s, r, i, imin(i + 3, m), false);
  }
}

template <int U, class T>
__device__ __forceinline__ void double_shift_sweep(T* H, T* Q, int m, int ld, Link<T>& l,
                                                   int frm, int to, T trace, T det) {
  const T h11 = H[frm * ld + frm], h21 = H[(frm + 1) * ld + frm];
  const T h12 = H[frm * ld + frm + 1], h22 = H[(frm + 1) * ld + frm + 1];
  const T h32 = H[(frm + 2) * ld + frm + 1];
  const T p1 = h11 * h11 + h12 * h21 - trace * h11 + det;
  const T p2 = h21 * (h11 + h22 - trace);
  const T p3 = h32 * h21;
  T c1, s1, c2, s2, r;
  rot3(p1, p2, p3, c1, s1, c2, s2, r);
  WSYNC();
  step3<U>(H, Q, m, ld, l, c1, s1, c2, s2, r, frm, true);
  for (int i = frm + 1; i < to - 1; ++i) {
    rot3(H[i * ld + i - 1], H[(i + 1) * ld + i - 1], H[(i + 2) * ld + i - 1], c1, s1,
         c2, s2, r);
    step3<U>(H, Q, m, ld, l, c1, s1, c2, s2, r, i, false);
  }
  T c, s;
  givens(H[(to - 1) * ld + to - 2], H[to * ld + to - 2], c, s, r);
  step2<U>(H, Q, m, ld, l, c, s, r, to - 1, imin(to + 1, m), false);
}

// Quasi-Schur form of the window [lo, hi) of H, accumulated into Q, by the
// chain warp, with the helper warp running `help` meanwhile when l.off.
// Returns true when the window finished within maxiter QR iterations.
template <int U, class T>
__device__ __forceinline__ bool local_schur(T* H, T* Q, int m, int ld, int lo, int hi,
                                            T eps, int maxiter, Link<T>& l) {
  int to = hi - 1;
  int it = 0;
  while (to > lo && it < maxiter) {
    int mx = -1;
    for (int j = lo + LANE; j < to; j += 32) {
      const T sub = vabs(H[(j + 1) * ld + j]);
      const T d0 = vabs(H[j * ld + j]), d1 = vabs(H[(j + 1) * ld + j + 1]);
      if (sub <= eps * (d0 + d1)) mx = imax(mx, j);
    }
    mx = warp_max(mx);
    const int frm = mx >= 0 ? mx + 1 : lo;
    if (mx >= 0) {
      WSYNC();
      if (LANE == 0) H[frm * ld + frm - 1] = T(0);
      WSYNC();
    }
    if (frm == to) {
      to -= 1;
    } else if (frm + 1 == to) {
      const T c11 = H[(to - 1) * ld + to - 1], c12 = H[(to - 1) * ld + to];
      const T c21 = H[to * ld + to - 1], c22 = H[to * ld + to];
      bool is_real;
      T c, s;
      upper_triangular_2x2(c11, c12, c21, c22, is_real, c, s);
      WSYNC();
      if (is_real) {
        ++l.steps;
        lmul2<U>(H, ld, c, s, frm, frm, m);
        rmul2<U>(Q, ld, c, s, frm, 0, m);
        WSYNC();
        rmul2<U>(H, ld, c, s, frm, 0, to + 1);
        WSYNC();
        if (LANE == 0) H[to * ld + to - 1] = T(0);
        WSYNC();
      }
      to -= 2;
    } else {
      const T c11 = H[(to - 1) * ld + to - 1], c12 = H[(to - 1) * ld + to];
      const T c21 = H[to * ld + to - 1], c22 = H[to * ld + to];
      T mu;
      ++l.sweeps;
      l.steps += to - frm;
      if (use_single_shift(c11, c12, c21, c22, mu))
        single_shift_sweep<U>(H, Q, m, ld, l, frm, to, mu);
      else
        double_shift_sweep<U>(H, Q, m, ld, l, frm, to, c11 + c22,
                              c11 * c22 - c12 * c21);
      if (l.off) join(l);
    }
    ++it;
  }
  stop(l);
  return to <= lo;
}

// --- eigenvalues of the quasi-triangular form (split-complex), block-wide ----------

// coupled[i] (i < m-1): H[i+1, i] is not negligible; starts[i]: a diagonal
// block starts at i (a pair's members do not chain).  Ends synchronized.
template <class T>
__device__ __forceinline__ void block_starts(const T* H, int m, int ld, T eps,
                                             int* coupled, int* starts) {
  for (int i = TID; i < m; i += NT) {
    coupled[i] = 0;
    if (i < m - 1) {
      const T d0 = vabs(H[i * ld + i]), d1 = vabs(H[(i + 1) * ld + i + 1]);
      coupled[i] = vabs(H[(i + 1) * ld + i]) > eps * (d0 + d1);
    }
  }
  SYNC();
  if (TID == 0) {
    bool in_pair = false;
    for (int i = 0; i < m; ++i) {
      starts[i] = !in_pair;
      in_pair = coupled[i] && !in_pair;
    }
  }
  SYNC();
}

// x, rr, y of the 2x2 block starting at i (zero-padded past m-1).
template <class T>
__device__ __forceinline__ void pair_values(const T* H, int m, int ld, int i, T& x, T& rr,
                                            T& y) {
  const T d = H[i * ld + i];
  const bool last = i == m - 1;
  const T dn = last ? T(0) : H[(i + 1) * ld + i + 1];
  const T sup = last ? T(0) : H[i * ld + i + 1];
  const T sub = last ? T(0) : H[(i + 1) * ld + i];
  x = (d + dn) / T(2);
  const T det = d * dn - sup * sub;
  const T disc = x * x - det;
  const T nd = -disc;
  y = vsqrt(nd < T(0) ? T(0) : nd);
  rr = vsqrt(disc < T(0) ? T(0) : disc);
}

// lam_re/lam_im of the m x m part of H; ends synchronized.
template <class T>
__device__ __forceinline__ void eigenvalues(const T* H, int m, int ld, T eps,
                                            int* coupled, int* starts, T* lre, T* lim) {
  block_starts(H, m, ld, eps, coupled, starts);
  for (int i = TID; i < m; i += NT) {
    const bool pstart = starts[i] && coupled[i];
    const bool psecond = i > 0 && starts[i - 1] && coupled[i - 1];
    T x, rr, y;
    if (pstart) {
      pair_values(H, m, ld, i, x, rr, y);
      lre[i] = x + rr;
      lim[i] = y;
    } else if (psecond) {
      pair_values(H, m, ld, i - 1, x, rr, y);
      lre[i] = x - rr;
      lim[i] = -y;
    } else {
      lre[i] = H[i * ld + i];
      lim[i] = T(0);
    }
  }
  SYNC();
}

// --- Ritz residuals by split-complex backward substitution ------------------------

template <class T>
__device__ __forceinline__ void cdiv(T ar, T ai, T br, T bi, T& cr, T& ci) {
  if (vabs(br) >= vabs(bi)) {
    const T r = bi / (br == T(0) ? T(1) : br);
    T den = br + bi * r;
    den = den == T(0) ? T(1) : den;
    cr = (ar + ai * r) / den;
    ci = (ai - ar * r) / den;
  } else {
    const T r = br / (bi == T(0) ? T(1) : bi);
    T den = bi + br * r;
    den = den == T(0) ? T(1) : den;
    cr = (ar * r + ai) / den;
    ci = (ai * r - ar) / den;
  }
}

// The eigenvector x (x_re, x_im: m slots) of the block holding diagonal
// index i, unnormalized, by one thread: the substitution of the plain
// version's `_residual`, whose sums the block takes afterwards.
template <class T>
__device__ __forceinline__ void ritz_vector(const T* __restrict__ H, int m, int ld, int i,
                                            T* __restrict__ x_re, T* __restrict__ x_im) {
  const int j = (i < m - 1 && H[(i + 1) * ld + i] != T(0)) ? i + 1 : i;
  const int jm1 = imax(j - 1, 0);
  const bool pair = j > 0 && H[j * ld + jm1] != T(0);
  const T b11 = H[jm1 * ld + jm1], b12 = H[jm1 * ld + j];
  const T b21 = H[j * ld + jm1], b22 = H[j * ld + j];
  T lr, li;
  if (pair) {
    const T tr2 = (b11 + b22) / T(2);
    const T disc = tr2 * tr2 - (b11 * b22 - b21 * b12);
    lr = tr2 + vsqrt(pmax(disc, T(0)));
    li = vsqrt(pmax(-disc, T(0)));
  } else {
    lr = b22;
    li = T(0);
  }
  for (int c = 0; c < m; ++c) x_re[c] = x_im[c] = T(0);
  int k;
  if (pair) {
    T xr, xi;
    cdiv(-b12, T(0), b11 - lr, -li, xr, xi);
    for (int c = 0; c < j - 1; ++c) {
      x_re[c] = -H[c * ld + jm1] * xr - H[c * ld + j];
      x_im[c] = -H[c * ld + jm1] * xi;
    }
    x_re[j - 1] = xr;
    x_im[j - 1] = xi;
    k = j - 1;
  } else {
    for (int c = 0; c < j; ++c) x_re[c] = -H[c * ld + j];
    k = j;
  }
  x_re[j] = T(1);
  while (k > 0) {
    if (k > 1 && vabs(H[(k - 1) * ld + k - 2]) > T(0)) {
      const int i2 = k - 2;
      const T r11 = H[i2 * ld + i2] - lr;
      const T r12 = H[i2 * ld + k - 1];
      const T r21 = H[(k - 1) * ld + i2];
      const T r22 = H[(k - 1) * ld + k - 1] - lr;
      const T det_re = r11 * r22 - li * li - r21 * r12;
      const T det_im = -li * (r11 + r22);
      const T b1r = x_re[i2], b1i = x_im[i2];
      const T b2r = x_re[k - 1], b2i = x_im[k - 1];
      const T n1r = r22 * b1r + li * b1i - r12 * b2r;
      const T n1i = r22 * b1i - li * b1r - r12 * b2i;
      const T n2r = -r21 * b1r + r11 * b2r + li * b2i;
      const T n2i = -r21 * b1i + r11 * b2i - li * b2r;
      T a1r, a1i, a2r, a2i;
      cdiv(n1r, n1i, det_re, det_im, a1r, a1i);
      cdiv(n2r, n2i, det_re, det_im, a2r, a2i);
      for (int c = 0; c < i2; ++c) {
        const T ca = H[c * ld + i2], cb = H[c * ld + k - 1];
        x_re[c] = x_re[c] - (ca * a1r + cb * a2r);
        x_im[c] = x_im[c] - (ca * a1i + cb * a2i);
      }
      x_re[i2] = a1r;
      x_im[i2] = a1i;
      x_re[k - 1] = a2r;
      x_im[k - 1] = a2i;
      k -= 2;
    } else {
      const T sr = H[(k - 1) * ld + k - 1] - lr;
      const T si = -li;
      T vr = T(0), vi = T(0);
      if (!(sr == T(0) && si == T(0))) cdiv(x_re[k - 1], x_im[k - 1], sr, si, vr, vi);
      for (int c = 0; c < k - 1; ++c) {
        const T ca = H[c * ld + k - 1];
        x_re[c] = x_re[c] - ca * vr;
        x_im[c] = x_im[c] - ca * vi;
      }
      x_re[k - 1] = vr;
      x_im[k - 1] = vi;
      k -= 1;
    }
  }
}

// |Q[m-1, :] y| for the unit eigenvector y = x / |x| (x at x_re, x_im), by
// one warp; lane 0's result.
template <class T>
__device__ __forceinline__ T residual(const T* qrow, int m, const T* x_re,
                                      const T* x_im) {
  T nrm = vsqrt(warp_tree<T>(m,
                [&](int c) { return x_re[c] * x_re[c] + x_im[c] * x_im[c]; }));
  nrm = nrm == T(0) ? T(1) : nrm;
  const T tr = warp_tree<T>(m, [&](int c) { return qrow[c] * x_re[c]; }) / nrm;
  const T ti = warp_tree<T>(m, [&](int c) { return qrow[c] * x_im[c]; }) / nrm;
  return vsqrt(tr * tr + ti * ti);
}

// --- Sylvester swaps and Schur reordering, by the chain warp -----------------------

// Complete-pivoting elimination of the N x N system M x = b (N = 2, 4) in
// the plain version's order; every lane solves it.  The loops unroll and
// the pivot swaps are selects, so M, x and the permutation stay in
// registers.  Returns singular.
template <class T, int N>
__device__ __forceinline__ bool solve_complete_pivot(T (&M)[N * N], T (&x)[N]) {
  int colperm[N];
#pragma unroll
  for (int c = 0; c < N; ++c) colperm[c] = c;
  bool singular = false;
#pragma unroll
  for (int k = 0; k < N - 1; ++k) {
    T best = T(-1);
    int bi = k, bj = k;
#pragma unroll
    for (int i = k; i < N; ++i)
#pragma unroll
      for (int j = k; j < N; ++j)
        if (vabs(M[i * N + j]) > best) {
          best = vabs(M[i * N + j]);
          bi = i;
          bj = j;
        }
#pragma unroll
    for (int i = k + 1; i < N; ++i)
      if (i == bi) {
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const T t = M[k * N + c];
          M[k * N + c] = M[i * N + c];
          M[i * N + c] = t;
        }
        const T t = x[k];
        x[k] = x[i];
        x[i] = t;
      }
#pragma unroll
    for (int j = k + 1; j < N; ++j)
      if (j == bj) {
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const T t = M[r * N + k];
          M[r * N + k] = M[r * N + j];
          M[r * N + j] = t;
        }
        const int t = colperm[k];
        colperm[k] = colperm[j];
        colperm[j] = t;
      }
    const T pivot = M[k * N + k];
    singular = singular || pivot == T(0);
    const T piv_s = pivot == T(0) ? T(1) : pivot;
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const T fac = M[r * N + k] / piv_s;
#pragma unroll
      for (int c = k + 1; c < N; ++c) M[r * N + c] = M[r * N + c] - fac * M[k * N + c];
      M[r * N + k] = fac;
      x[r] = x[r] - fac * x[k];
    }
  }
  singular = singular || M[(N - 1) * N + N - 1] == T(0);
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T e[N];
#pragma unroll
    for (int c = 0; c < N; ++c) e[c] = c > i ? M[i * N + c] * x[c] : T(0);
#pragma unroll
    for (int h = N / 2; h >= 1; h /= 2)
#pragma unroll
      for (int c = 0; c < h; ++c) e[c] = e[c] + e[c + h];
    const T piv = M[i * N + i];
    x[i] = (x[i] - e[0]) / (piv == T(0) ? T(1) : piv);
  }
  // out[colperm[r]] = x[r].
  T out[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    out[c] = x[0];
#pragma unroll
    for (int r = 1; r < N; ++r)
      if (colperm[r] == c) out[c] = x[r];
  }
#pragma unroll
  for (int r = 0; r < N; ++r) x[r] = out[r];
  return singular;
}

// X (p x q, column-major in X[a * p + c] = X[c, a]) solving
// A X - X B = C with A = H[i:i+p, i:i+p], B the q x q block after it and
// C = H[i:i+p, i+p:i+p+q].
template <class T, int p, int q>
__device__ __forceinline__ bool sylv(const T* H, int ld, int i, T (&X)[p * q]) {
  constexpr int N = p * q;
  T M[N * N];
  const int bo = i + p;
#pragma unroll
  for (int a = 0; a < q; ++a)
#pragma unroll
    for (int c = 0; c < p; ++c)
#pragma unroll
      for (int b = 0; b < q; ++b)
#pragma unroll
        for (int d = 0; d < p; ++d) {
          const T va = a == b ? H[(i + c) * ld + i + d] : T(0);
          const T vb = c == d ? H[(bo + b) * ld + bo + a] : T(0);
          M[(a * p + c) * N + b * p + d] = va - vb;
        }
#pragma unroll
  for (int a = 0; a < q; ++a)
#pragma unroll
    for (int c = 0; c < p; ++c) X[a * p + c] = H[(i + c) * ld + bo + a];
  return solve_complete_pivot<T, N>(M, X);
}

// Q's share of a swap's rotation: published to the helper, or applied by
// the chain.
template <int U, class T>
__device__ __forceinline__ void qmul2(T* Q, int m, int ld, Link<T>& l, T c, T s, int i) {
  if (l.off) publish(l, R_TWO, i, 0, c, s, T(0), T(0));
  else rmul2<U>(Q, ld, c, s, i, 0, m);
}

template <int U, class T>
__device__ __forceinline__ void qmul3(T* Q, int m, int ld, Link<T>& l, T c1, T s1, T c2,
                                      T s2, int i) {
  if (l.off) publish(l, R_THREE, i, 0, c1, s1, c2, s2);
  else rmul3<U>(Q, ld, c1, s1, c2, s2, i, 0, m);
}

template <int U, class T>
__device__ __forceinline__ void swap11(T* H, T* Q, int m, int ld, Link<T>& l, int i) {
  const T r11 = H[i * ld + i], r12 = H[i * ld + i + 1], r22 = H[(i + 1) * ld + i + 1];
  T c, s, r;
  givens(r12, r22 - r11, c, s, r);
  WSYNC();
  ++l.steps;
  lmul2<U>(H, ld, c, s, i, i + 2, m);
  rmul2<U>(H, ld, c, s, i, 0, i);
  qmul2<U>(Q, m, ld, l, c, s, i);
  if (LANE == 0) {
    H[i * ld + i] = r22;
    H[(i + 1) * ld + i + 1] = r11;
  }
  WSYNC();
}

template <int U, class T>
__device__ __forceinline__ void swap12(T* H, T* Q, int m, int ld, Link<T>& l, int i) {
  T X[2];
  const bool singular = sylv<T, 1, 2>(H, ld, i, X);
  WSYNC();
  if (singular) return;
  T c1, s1, c2, s2, r;
  givens(-X[0], T(1), c1, s1, r);  // X[0, 0]
  const T x22 = -s1 * -X[1];       // X[0, 1]
  givens(x22, T(1), c2, s2, r);
  l.steps += 2;
  lmul2<U>(H, ld, c1, s1, i, i, m);
  qmul2<U>(Q, m, ld, l, c1, s1, i);
  WSYNC();
  rmul2<U>(H, ld, c1, s1, i, 0, i + 3);
  WSYNC();
  lmul2<U>(H, ld, c2, s2, i + 1, i, m);
  qmul2<U>(Q, m, ld, l, c2, s2, i + 1);
  WSYNC();
  rmul2<U>(H, ld, c2, s2, i + 1, 0, i + 3);
  WSYNC();
  if (LANE == 0) {
    H[(i + 2) * ld + i] = T(0);
    H[(i + 2) * ld + i + 1] = T(0);
  }
  WSYNC();
}

template <int U, class T>
__device__ __forceinline__ void swap21(T* H, T* Q, int m, int ld, Link<T>& l, int i) {
  T X[2];
  const bool singular = sylv<T, 2, 1>(H, ld, i, X);
  WSYNC();
  if (singular) return;
  T c1, s1, n1, c2, s2, r;
  givens(-X[1], T(1), c1, s1, n1);  // X[1, 0]
  givens(-X[0], n1, c2, s2, r);     // X[0, 0]
  ++l.steps;
  lmul3<U>(H, ld, c1, s1, c2, s2, i, i, m);
  qmul3<U>(Q, m, ld, l, c1, s1, c2, s2, i);
  WSYNC();
  rmul3<U>(H, ld, c1, s1, c2, s2, i, 0, i + 3);
  WSYNC();
  if (LANE == 0) {
    H[(i + 1) * ld + i] = T(0);
    H[(i + 2) * ld + i] = T(0);
  }
  WSYNC();
}

template <int U, class T>
__device__ __forceinline__ void swap22(T* H, T* Q, int m, int ld, Link<T>& l, int i) {
  T X[4];
  const bool singular = sylv<T, 2, 2>(H, ld, i, X);
  WSYNC();
  if (singular) return;
  // X[c, a] = X[a * 2 + c].
  T c1, s1, n1, c2, s2, r, c3, s3, n3, c4, s4;
  givens(-X[1], T(1), c1, s1, n1);  // X[1, 0]
  givens(-X[0], n1, c2, s2, r);     // X[0, 0]
  T x22 = c1 * -X[3];               // X[1, 1]
  const T x32 = -s1 * -X[3];
  x22 = -s2 * -X[2] + c2 * x22;     // X[0, 1]
  givens(x32, T(1), c3, s3, n3);
  givens(x22, n3, c4, s4, r);
  l.steps += 2;
  lmul3<U>(H, ld, c1, s1, c2, s2, i, i, m);
  qmul3<U>(Q, m, ld, l, c1, s1, c2, s2, i);
  WSYNC();
  rmul3<U>(H, ld, c1, s1, c2, s2, i, 0, i + 4);
  WSYNC();
  lmul3<U>(H, ld, c3, s3, c4, s4, i + 1, i, m);
  qmul3<U>(Q, m, ld, l, c3, s3, c4, s4, i + 1);
  WSYNC();
  rmul3<U>(H, ld, c3, s3, c4, s4, i + 1, 0, i + 4);
  WSYNC();
  if (LANE == 0) {
    H[(i + 2) * ld + i] = T(0);
    H[(i + 3) * ld + i] = T(0);
    H[(i + 2) * ld + i + 1] = T(0);
    H[(i + 3) * ld + i + 1] = T(0);
  }
  WSYNC();
}

template <class T>
__device__ __forceinline__ bool is_start_11(const T* H, int m, int ld, int i) {
  return i == m - 1 || H[imin(i + 1, m - 1) * ld + i] == T(0);
}

template <class T>
__device__ __forceinline__ bool is_end_11(const T* H, int ld, int i) {
  return i == 0 || H[i * ld + imax(i - 1, 0)] == T(0);
}

// Every swap starts by reading H and synchronizes the warp before its
// first write, so the block decisions read before it are safe.
template <int U, class T>
__device__ __forceinline__ void swap(T* H, T* Q, int m, int ld, Link<T>& l, int i,
                                     bool curr_11, bool next_11) {
  if (curr_11 && next_11) swap11<U>(H, Q, m, ld, l, i);
  else if (curr_11) swap12<U>(H, Q, m, ld, l, i);
  else if (next_11) swap21<U>(H, Q, m, ld, l, i);
  else swap22<U>(H, Q, m, ld, l, i);
}

template <int U, class T>
__device__ __forceinline__ void rotate_right(T* H, T* Q, int m, int ld, Link<T>& l,
                                             int frm, int to) {
  int i = to;
  while (i > frm) {
    const bool curr_11 = is_start_11(H, m, ld, i);
    const bool prev_11 = is_end_11(H, ld, i - 1);
    const int j = prev_11 ? i - 1 : i - 2;
    swap<U>(H, Q, m, ld, l, j, prev_11, curr_11);
    i = j;
  }
}

template <int U, class T>
__device__ __forceinline__ void partition_three_way(T* H, T* Q, int m, int ld,
                                                    const int* groups, Link<T>& l) {
  int hi = 0, mi = 0, lo = 0;
  while (hi < m) {
    const int group = groups[imin(hi, m - 1)];
    const int bs = is_start_11(H, m, ld, hi) ? 1 : 2;
    if (group <= 1) {
      rotate_right<U>(H, Q, m, ld, l, lo, hi);
      lo += bs;
      mi += bs;
    } else if (group == 2) {
      rotate_right<U>(H, Q, m, ld, l, mi, hi);
      mi += bs;
    }
    hi += bs;
    WSYNC();
  }
  stop(l);
}

enum { LM = 0, LR = 1, SR = 2, LI = 3, SI = 4 };

template <class T>
__device__ __forceinline__ T order_key(int which, T re, T im) {
  switch (which) {
    case LM: return -hyp(re, im);
    case LR: return -re;
    case SR: return re;
    case LI: return -im;
    default: return im;
  }
}

template <class T>
__device__ __forceinline__ T block_eig_key(const T* H, int m, int ld, int i, int which) {
  if (is_start_11(H, m, ld, i)) return order_key(which, H[i * ld + i], T(0));
  const int i1 = imin(i + 1, m - 1);
  const T b11 = H[i * ld + i], b12 = H[i * ld + i1];
  const T b21 = H[i1 * ld + i], b22 = H[i1 * ld + i1];
  const T x = (b11 + b22) / T(2);
  const T disc = x * x - (b11 * b22 - b12 * b21);
  return order_key(which, x + vsqrt(pmax(disc, T(0))), vsqrt(pmax(-disc, T(0))));
}

template <int U, class T>
__device__ __forceinline__ void sort_schur(T* H, T* Q, int m, int ld, Link<T>& l,
                                           int count, int which) {
  int nxt = 0;
  while (nxt < count) {
    int curr = nxt;
    const int curr_size0 = is_start_11(H, m, ld, curr) ? 1 : 2;
    const T key_curr = block_eig_key(H, m, ld, curr, which);
    while (curr > 0) {
      const int prev_size = is_end_11(H, ld, curr - 1) ? 1 : 2;
      const int prev = curr - prev_size;
      if (!(key_curr < block_eig_key(H, m, ld, imax(prev, 0), which))) break;
      const int curr_size = is_start_11(H, m, ld, curr) ? 1 : 2;
      swap<U>(H, Q, m, ld, l, prev, prev_size == 1, curr_size == 1);
      curr = prev;
    }
    nxt += curr_size0;
    WSYNC();
  }
}

// --- Hessenberg restoration after truncation --------------------------------------

// Scratch of the restore, in shared memory: vaug, dv (m+1 each), d2 (m)
// and the reflector's squared norm.
template <class T>
struct RestoreScratch {
  T* vaug;
  T* dv;
  T* d2;
  T* xnrm2;
};

// The Givens pass by the chain warp, then the Householder sweeps
// block-wide.  Called by the whole block; ends synchronized.
template <int U, class T>
__device__ __forceinline__ void restore_arnoldi(T* H, T* Q, int m, int ld, int lo, int hi,
                                                RestoreScratch<T> w, Link<T>& l) {
  if (lo >= hi - 1) return;
  const int last = m - 1;
  if (TID < 32) {
    l.steps += hi - 1 - lo;
    T nrm = Q[last * ld + lo];
    for (int i = lo; i < hi - 1; ++i) {
      T c, s, nrm2;
      givens(Q[last * ld + i + 1], nrm, c, s, nrm2);
      const T ns = -s;
      rmul2<U>(H, ld, c, ns, i, 0, imin(i + 3, hi));
      WSYNC();
      lmul2<U>(H, ld, c, ns, i, 0, hi);
      rmul2<U>(Q, ld, c, ns, i, 0, m);
      WSYNC();
      nrm = nrm2;
    }
    if (LANE == 0) H[hi * ld + hi - 1] = Q[last * ld + hi - 1] * H[m * ld + m - 1];
  }
  SYNC();

  const int warp = TID / 32, nwarps = NT / 32;
  const int nsweeps = imax(hi - 1 - lo - 1, 0);
  for (int t = 0; t < nsweeps; ++t) {
    const int length = (hi - 1 - lo) - t;
    const int row = lo + length;
    const int lastc = row - 1;
    const T* hrow = H + row * ld;
    const T alpha = hrow[lastc];
    if (warp == 0) {
      const T x2 = warp_tree<T>(m, [&](int c) {
        const T h = hrow[c];
        return (c >= lo && c < lastc) ? h * h : T(0);
      });
      if (LANE == 0) *w.xnrm2 = x2;
    }
    SYNC();
    const T xnrm2 = *w.xnrm2;
    const T beta = -vcopysign(hyp(vabs(alpha), vsqrt(xnrm2)), alpha);
    const T beta_s = beta == T(0) ? T(1) : beta;
    const T tau = xnrm2 == T(0) ? T(0) : (beta - alpha) / beta_s;
    T denom = alpha - beta;
    denom = denom == T(0) ? T(1) : denom;
    const T beta_w = xnrm2 == T(0) ? alpha : beta;
    for (int c = TID; c <= m; c += NT) {
      if (c == m) {
        w.vaug[c] = T(0);
      } else {
        const T v = (c >= lo && c < lastc) ? hrow[c] / denom : T(0);
        w.vaug[c] = v + (c == lastc ? T(1) : T(0));
      }
    }
    SYNC();
    // Column-space application to H's rows [0, row): a warp a row.
    for (int r = warp; r <= m; r += nwarps) {
      T d = T(0);
      if (r < row) {
        const T* hr = H + r * ld;
        d = tau * warp_tree<T>(m, [&](int c) { return hr[c] * w.vaug[c]; });
      }
      if (LANE == 0) w.dv[r] = d;
    }
    SYNC();
    block_rows(m + 1, m, [&](int r, int c) {
      H[r * ld + c] = H[r * ld + c] - w.dv[r] * w.vaug[c];
    });
    SYNC();
    for (int c = TID; c < m; c += NT) {
      const T h = H[row * ld + c];
      H[row * ld + c] = (c >= lo && c < lastc) ? T(0) : (c == lastc ? beta_w : h);
    }
    SYNC();
    // Row-space application to H's columns [lo, hi): a warp a column.
    for (int c = warp; c < m; c += nwarps) {
      T d = T(0);
      if (c >= lo && c < hi)
        d = tau * warp_tree<T>(m + 1, [&](int r) { return w.vaug[r] * H[r * ld + c]; });
      if (LANE == 0) w.d2[c] = d;
    }
    SYNC();
    block_rows(m + 1, m, [&](int r, int c) {
      H[r * ld + c] = H[r * ld + c] - w.vaug[r] * w.d2[c];
    });
    // Column-space application to Q (every row): a warp a row.
    for (int r = warp; r < m; r += nwarps) {
      const T* qr = Q + r * ld;
      const T d = tau * warp_tree<T>(m, [&](int c) { return qr[c] * w.vaug[c]; });
      if (LANE == 0) w.dv[r] = d;
    }
    SYNC();
    block_rows(m, m, [&](int r, int c) {
      Q[r * ld + c] = Q[r * ld + c] - w.dv[r] * w.vaug[c];
    });
    SYNC();
  }
}

// --- storage ------------------------------------------------------------------------

// Row stride of H and Q in shared memory: odd, so that the 32 rows a warp
// walks down a column fall in 32 banks (in float, and in double's pairs).
__host__ __device__ inline int shared_ld(int m) { return m | 1; }

// The dynamic shared memory a launch may ask for: an H100 block's 232,448
// bytes less 2 KB for the kernels' static shared memory.
constexpr long long SMEM_LIMIT = 232448 - 2048;

// Dynamic shared memory of a launch: the restore's scratch (rounded to an
// even count), then, with shared storage, H and Q at stride shared_ld(m)
// and, where they fit too, the residuals' vectors (2 m rows).
__host__ __device__ inline long long scratch_elems(int m) {
  return (3LL * m + 3 + 1) / 2 * 2;
}
__host__ __device__ inline bool x_shared(int m, int item) {
  return (scratch_elems(m) + (4LL * m + 1) * shared_ld(m)) * item <= SMEM_LIMIT;
}
__host__ __device__ inline long long smem_bytes(int m, int item, bool shared) {
  const long long rows = shared ? 2LL * m + 1 + (x_shared(m, item) ? 2LL * m : 0) : 0;
  return (scratch_elems(m) + rows * shared_ld(m)) * item;
}

// Where a launch keeps H and Q: shared memory (copied in at entry, written
// back at exit) or the caller's arrays in global memory.
template <class T>
struct Store {
  T* H;
  T* Q;
  int ld;
  RestoreScratch<T> rw;
};

template <bool SHARED, class T>
__device__ __forceinline__ Store<T> make_store(T* smem, T* H, T* Q, int m) {
  Store<T> s;
  s.rw.vaug = smem;
  s.rw.dv = s.rw.vaug + (m + 1);
  s.rw.d2 = s.rw.dv + (m + 1);
  s.rw.xnrm2 = s.rw.d2 + m;
  if constexpr (SHARED) {
    s.ld = shared_ld(m);
    s.H = smem + scratch_elems(m);
    s.Q = s.H + (long long)(m + 1) * s.ld;
  } else {
    s.ld = m;
    s.H = H;
    s.Q = Q;
  }
  return s;
}

// dst (rows x cols at stride dld) = src (at stride sld), block-wide.
template <class T>
__device__ __forceinline__ void copy_rows(T* dst, int dld, const T* src, int sld,
                                          int rows, int cols) {
  block_rows(rows, cols, [&](int r, int c) { dst[r * dld + c] = src[r * sld + c]; });
}

// --- the two kernels ----------------------------------------------------------------

// Slots of the int32 loop state (dense/device.py: STATE).
enum { S_ACTIVE = 0, S_PRODS, S_IT, S_PURGES, S_DONE, S_QR_OK, S_K, S_ROLLBACK };

// The global scratch a call needs: work (T: lre, lim, rs, rs2, keys, the
// residuals' vectors and the tree slots of H's norm) and iwork (int)
// element counts.
__host__ __device__ inline long long work_len(int m) {
  return 5LL * m + 2LL * m * m + pow2_at_least((m + 1) * m);
}
__host__ __device__ inline long long iwork_len(int m) { return 6LL * m; }

template <class T>
struct Work {
  T *lre, *lim, *rs, *rs2, *keys, *xre, *xim, *ts;
  int *coupled, *starts, *order, *groups, *conv, *pairat;
  __device__ Work(T* w, int* iw, int m) {
    lre = w;
    lim = lre + m;
    rs = lim + m;
    rs2 = rs + m;
    keys = rs2 + m;
    xre = keys + m;
    xim = xre + (long long)m * m;
    ts = xim + (long long)m * m;
    coupled = iw;
    starts = coupled + m;
    order = starts + m;
    groups = order + m;
    conv = groups + m;
    pairat = conv + m;
  }
};

template <class T> __device__ T eps_of();
template <> __device__ float eps_of<float>() { return 1.1920928955078125e-07f; }
template <> __device__ double eps_of<double>() { return 2.220446049250313e-16; }

// The clock64() stamps of a restart launch, thread 0's after a barrier:
// entry, then the end of each phase.
enum {
  P_ENTRY = 0, P_FLAGS, P_SCHUR, P_RESIDUALS, P_GROUPS, P_PARTITION, P_RESTORE,
  P_QBIG, N_STAMPS
};

__device__ __forceinline__ void stamp(long long* stamps, int p) {
  if (stamps != nullptr && TID == 0) stamps[p] = clock64();
}

template <class T>
__device__ __forceinline__ void set_eye(T* A, int ld, int m) {
  block_rows(m, m, [&](int r, int c) { A[r * ld + c] = r == c ? T(1) : T(0); });
}

// U: elements a lane loads before it stores in the row and column updates.
template <class T, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS, 1)
restart_kernel(T* H, T* Q, T* Qbig, int* state, const T* flags, int* info, T* work,
               int* iwork, long long* stamps, int m, int nev, int mindim, double tol_d,
               int restarts, int which, int maxiter, int helper) {
  constexpr int U = SHARED ? 1 : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Ring<T> ring;
  stamp(stamps, P_ENTRY);
  if (TID == 0) ring.head = ring.tail = 0;
  // The last expansion range's breakdown flags: roll back at the first.
  int jb = m;
  for (int j = TID; j < m; j += NT)
    if (flags[j] != T(0)) jb = imin(jb, j);
  jb = block_min(jb);
  if (jb < m) {
    if (TID == 0) state[S_ROLLBACK] = jb;
    for (int p = P_FLAGS; p < N_STAMPS; ++p) stamp(stamps, p);
    return;
  }
  const int active = state[S_ACTIVE];
  const int it = state[S_IT] + 1;
  const int purges = state[S_PURGES];
  const int prods = state[S_PRODS];
  const int qr_ok = state[S_QR_OK];
  Work<T> w(work, iwork, m);
  const T eps = eps_of<T>();
  const Store<T> st = make_store<SHARED>(reinterpret_cast<T*>(smem_raw), H, Q, m);
  T* const Hs = st.H;
  T* const Qs = st.Q;
  const int ld = st.ld;

  if (SHARED) copy_rows(Hs, ld, H, m, m + 1, m);
  set_eye(Qs, ld, m);
  SYNC();
  stamp(stamps, P_FLAGS);
  bool ok = true;
  Link<T> link{ring, helper && NT > 32, 0, RING, 0, 0};
  if (TID < 32)
    ok = local_schur<U>(Hs, Qs, m, ld, active, m, eps, maxiter, link);
  else if (TID < 64 && link.off)
    help<U>(Hs, Qs, m, ld, ring);
  SYNC();
  stamp(stamps, P_SCHUR);
  eigenvalues(Hs, m, ld, eps, w.coupled, w.starts, w.lre, w.lim);

  // Residuals: a thread's substitution for each Ritz position, in shared
  // memory where it fits, then a warp's sums; then the Schur-coupling floor
  // and the max over each pair.
  const T hl = vabs(Hs[m * ld + m - 1]);
  const T* qrow = Qs + (m - 1) * ld;
  const bool xs = SHARED && x_shared(m, sizeof(T));
  const int ldx = xs ? ld : m;
  T* const xre = xs ? Qs + m * ld : w.xre;
  T* const xim = xre + (long long)m * ldx;
  for (int i = active + TID; i < m; i += NT)
    ritz_vector(Hs, m, ld, i, xre + (long long)i * ldx, xim + (long long)i * ldx);
  SYNC();
  for (int i = TID / 32; i < m; i += NT / 32) {
    T r = T(0);
    if (i >= active)
      r = residual(qrow, m, xre + (long long)i * ldx, xim + (long long)i * ldx) * hl;
    if (LANE == 0) w.rs[i] = r;
  }
  SYNC();
  for (int i = TID; i < m; i += NT) {
    const T cp = hl * vabs(qrow[i]);
    w.rs2[i] = w.rs[i] > cp ? w.rs[i] : cp;
  }
  SYNC();
  for (int i = TID; i < m; i += NT) {
    const bool first = i < m - 1 && Hs[(i + 1) * ld + i] != T(0);
    w.rs[i] = first ? (w.rs2[i + 1] > w.rs2[i] ? w.rs2[i + 1] : w.rs2[i]) : w.rs2[i];
  }
  SYNC();
  for (int i = TID; i < m; i += NT) {
    const bool second = i > 0 && Hs[i * ld + i - 1] != T(0);
    w.rs2[i] = second ? (w.rs[i - 1] > w.rs[i] ? w.rs[i - 1] : w.rs[i]) : w.rs[i];
  }
  // H's squares in row-major order, as the plain version flattens H.
  block_rows(m + 1, m, [&](int r, int c) {
    const T h = Hs[r * ld + c];
    w.ts[r * m + c] = h * h;
  });
  SYNC();
  const T hfrob = vsqrt(block_tree(w.ts, (m + 1) * m));
  stamp(stamps, P_RESIDUALS);

  // The stable sort by the target's key: rank = smaller keys + equal keys
  // at lower indices.
  for (int i = TID; i < m; i += NT) w.keys[i] = order_key(which, w.lre[i], w.lim[i]);
  SYNC();
  for (int i = TID; i < m; i += NT) {
    int rank = 0;
    const T ki = w.keys[i];
    for (int j = 0; j < m; ++j) rank += w.keys[j] < ki || (j < i && w.keys[j] == ki);
    w.order[rank] = i;
  }
  SYNC();
  const T tol = static_cast<T>(tol_d);
  const T efloor = eps * hfrob;
  for (int p = TID; p < m; p += NT) {
    const int o = w.order[p];
    const T f2 = tol * hyp(w.lre[o], w.lim[o]);
    w.conv[p] = w.rs2[o] <= (f2 > efloor ? f2 : efloor);
    int pr = 0;
    if (p < m - 1) {
      const int o2 = w.order[p + 1];
      pr = w.lim[o] != T(0) && w.lre[o] == w.lre[o2] && w.lim[o] == -w.lim[o2];
    }
    w.pairat[p] = pr;
  }
  SYNC();

  // Locking count and the group walk (every thread; thread 0 writes).
  const int eff = nev + w.pairat[imax(nev - 1, 0)];
  int nlock = 0;
  for (int p = 0; p < imin(eff, m); ++p) nlock += w.conv[p];
  const int ideal = imin(nlock + mindim, (mindim + m) / 2);
  int k = eff, grp = 0;
  bool skip = false;
  for (int pos = 0; pos < m; ++pos) {
    const bool in_tail = pos >= eff;
    const bool conv = w.conv[pos];
    const int lead = (k < ideal && !conv) ? 2 : 3;
    grp = skip ? grp : lead;
    if (in_tail && !skip && grp == 2) k += w.pairat[pos] ? 2 : 1;
    if (TID == 0) w.groups[w.order[pos]] = in_tail ? grp : (conv ? 1 : 2);
    skip = in_tail && !skip && w.pairat[pos];
  }
  SYNC();
  int purge = active;
  for (int i = 0; i < active; ++i)
    if (w.groups[i] != 1) { purge = i; break; }
  stamp(stamps, P_GROUPS);

  if (TID < 32)
    partition_three_way<U>(Hs, Qs, m, ld, w.groups, link);
  else if (TID < 64 && link.off)
    help<U>(Hs, Qs, m, ld, ring);
  SYNC();
  stamp(stamps, P_PARTITION);
  restore_arnoldi<U>(Hs, Qs, m, ld, nlock, k, st.rw, link);
  SYNC();
  stamp(stamps, P_RESTORE);

  // Qbig: columns [purge, k) from Q's rows [purge, m); column k takes the
  // old row m; identity elsewhere.
  const int m1 = m + 1;
  block_rows(m1, m1, [&](int r, int c) {
    T v = r == c ? T(1) : T(0);
    if (c >= purge && c < k) v = (r >= purge && r < m) ? Qs[r * ld + c] : T(0);
    if (k < m && c == k) v = r == m ? T(1) : T(0);
    Qbig[r * m1 + c] = v;
  });
  if (SHARED) {
    copy_rows(H, m, Hs, ld, m + 1, m);
    copy_rows(Q, m, Qs, ld, m, m);
  }
  for (int p = TID; p < m; p += NT) {
    info[4 + p] = w.order[p];
    info[4 + m + p] = w.groups[p];
  }
  if (TID == 0) {
    const bool done = nlock >= nev || it >= restarts;
    state[S_ACTIVE] = nlock;
    state[S_IT] = it;
    state[S_PURGES] = purges + (purge < active ? 1 : 0);
    state[S_DONE] = done;
    state[S_QR_OK] = qr_ok & (ok ? 1 : 0);
    state[S_K] = k;
    state[S_PRODS] = prods + (done ? 0 : m - k);
    state[S_ROLLBACK] = -1;
    info[0] = nlock;
    info[1] = k;
    info[2] = purge;
    info[3] = eff;
    info[4 + 2 * m] = link.sweeps;
    info[5 + 2 * m] = link.steps;
  }
  SYNC();
  stamp(stamps, P_QBIG);
}

template <class T, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS, 1)
finish_kernel(T* H, T* Q, T* Qbig, T* lam, const int* state, int* iwork, int m,
              int which) {
  constexpr int U = SHARED ? 1 : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int count = state[S_ACTIVE];
  const Store<T> st = make_store<SHARED>(reinterpret_cast<T*>(smem_raw), H, Q, m);
  T* const Hs = st.H;
  T* const Qs = st.Q;
  const int ld = st.ld;
  if (SHARED) copy_rows(Hs, ld, H, m, m + 1, m);
  set_eye(Qs, ld, m);
  SYNC();
  // The final sort's chain applies Q's rotations itself.
  __shared__ Ring<T> ring;
  Link<T> link{ring, false, 0, RING, 0, 0};
  if (TID < 32) sort_schur<U>(Hs, Qs, m, ld, link, count, which);
  SYNC();
  const int m1 = m + 1;
  block_rows(m1, m1, [&](int r, int c) {
    Qbig[r * m1 + c] = (r < m && c < m) ? Qs[r * ld + c] : (r == c ? T(1) : T(0));
  });
  if (SHARED) {
    copy_rows(H, m, Hs, ld, m + 1, m);
    copy_rows(Q, m, Qs, ld, m, m);
  }
  eigenvalues(Hs, m, ld, eps_of<T>(), iwork, iwork + m, lam, lam + m);
}

// Dynamic shared memory above 48 KB has to be allowed for the kernel.
template <class K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool bad_launch(int m, int threads) {
  return m < 2 || m > MAX_M || threads < 32 || threads > MAX_THREADS || threads % 32 != 0;
}

template <class T, bool SHARED>
int launch_restart_as(void* H, void* Q, void* Qbig, void* state, const void* flags,
                      void* info, void* work, void* iwork, void* stamps, int m, int nev,
                      int mindim, double tol, int restarts, int which, int maxiter,
                      int helper, int threads, void* stream) {
  if (bad_launch(m, threads)) return cudaErrorInvalidValue;
  const long long bytes = smem_bytes(m, sizeof(T), SHARED);
  const cudaError_t err = allow_smem(restart_kernel<T, SHARED>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  restart_kernel<T, SHARED><<<1, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(H), static_cast<T*>(Q), static_cast<T*>(Qbig),
      static_cast<int*>(state), static_cast<const T*>(flags), static_cast<int*>(info),
      static_cast<T*>(work), static_cast<int*>(iwork), static_cast<long long*>(stamps),
      m, nev, mindim, tol, restarts, which, maxiter, helper);
  return static_cast<int>(cudaGetLastError());
}

template <class T, bool SHARED>
int launch_finish_as(void* H, void* Q, void* Qbig, void* lam, const void* state,
                     void* iwork, int m, int which, int threads, void* stream) {
  if (bad_launch(m, threads)) return cudaErrorInvalidValue;
  const long long bytes = smem_bytes(m, sizeof(T), SHARED);
  const cudaError_t err = allow_smem(finish_kernel<T, SHARED>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<T, SHARED><<<1, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(H), static_cast<T*>(Q), static_cast<T*>(Qbig), static_cast<T*>(lam),
      static_cast<const int*>(state), static_cast<int*>(iwork), m, which);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of a launch's storage.
template <class T>
int launch_restart(void* H, void* Q, void* Qbig, void* state, const void* flags,
                   void* info, void* work, void* iwork, void* stamps, int m, int nev,
                   int mindim, double tol, int restarts, int which, int maxiter,
                   int shared, int helper, int threads, void* stream) {
  auto f = shared ? launch_restart_as<T, true> : launch_restart_as<T, false>;
  return f(H, Q, Qbig, state, flags, info, work, iwork, stamps, m, nev, mindim, tol,
           restarts, which, maxiter, helper, threads, stream);
}

template <class T>
int launch_finish(void* H, void* Q, void* Qbig, void* lam, const void* state, void* iwork,
                  int m, int which, int shared, int threads, void* stream) {
  auto f = shared ? launch_finish_as<T, true> : launch_finish_as<T, false>;
  return f(H, Q, Qbig, lam, state, iwork, m, which, threads, stream);
}

}  // namespace

extern "C" {

long long dense_restart_work_len(int m) { return work_len(m); }
long long dense_restart_iwork_len(int m) { return iwork_len(m); }
// Dynamic shared memory of a launch with H and Q in shared memory (shared
// = 1) or in global memory (0).
long long dense_restart_smem_bytes(int m, int item, int shared) {
  return smem_bytes(m, item, shared != 0);
}
long long dense_restart_shared_limit() { return SMEM_LIMIT; }

#define RESTART_ARGS                                                              \
  void *H, void *Q, void *Qbig, void *state, const void *flags, void *info,       \
      void *work, void *iwork, void *stamps, int m, int nev, int mindim,          \
      double tol, int restarts, int which, int maxiter, int shared, int helper,   \
      int threads, void *stream
#define RESTART_PASS                                                              \
  H, Q, Qbig, state, flags, info, work, iwork, stamps, m, nev, mindim, tol,       \
      restarts, which, maxiter, shared, helper, threads, stream
#define FINISH_ARGS                                                               \
  void *H, void *Q, void *Qbig, void *lam, const void *state, void *iwork, int m, \
      int which, int shared, int threads, void *stream
#define FINISH_PASS H, Q, Qbig, lam, state, iwork, m, which, shared, threads, stream

int dense_restart_f32(RESTART_ARGS) { return launch_restart<float>(RESTART_PASS); }
int dense_restart_f64(RESTART_ARGS) { return launch_restart<double>(RESTART_PASS); }
int dense_finish_f32(FINISH_ARGS) { return launch_finish<float>(FINISH_PASS); }
int dense_finish_f64(FINISH_ARGS) { return launch_finish<double>(FINISH_PASS); }

}  // extern "C"
