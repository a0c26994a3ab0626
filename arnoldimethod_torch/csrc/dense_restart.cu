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
// chase, the swaps and the Householder sweep are sequences of rotations in
// which each one reads what the last one wrote, so the kernel runs on one
// SM: one CTA, H (m+1) x m and Q m x m in global scratch (51 KB at m = 80
// float, held in L1/L2).  The design: each rotation is spread over the
// block's threads along its row or column range, with __syncthreads()
// between dependent applications (two or three a rotation); every scalar
// decision (deflation, shifts, rotations, the case switches, the group
// walk, the <= 4 x 4 complete-pivot Sylvester solves) is computed by every
// thread from the same data, so it needs no broadcast; searches and sums
// are block reductions.  Making it fast (H and Q in shared memory, a warp
// per rotation, fewer barriers) is later work.
//
// Arithmetic: every operation is the plain version's
// (arnoldimethod_torch/dense/device.py) in the same order, so the branches
// follow it: the kernel is compiled with --fmad=false (no contraction),
// every sum is tree_sum's fixed pairwise tree (zero-padded to a power of
// two, x[i] += x[i + h] for h = P/2 .. 1), and hypot is JAX's formula.

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

#define TID static_cast<int>(threadIdx.x)
#define NT static_cast<int>(blockDim.x)
#define SYNC() __syncthreads()

// --- block reductions --------------------------------------------------------

// Every thread gets the maximum (or minimum) of the block's values.
template <bool MAX>
__device__ int block_ext(int v) {
  __shared__ int red[32];
  for (int off = 16; off > 0; off /= 2) {
    const int o = __shfl_down_sync(0xffffffffu, v, off);
    v = MAX ? imax(v, o) : imin(v, o);
  }
  if (TID % 32 == 0) red[TID / 32] = v;
  SYNC();
  int r = red[0];
  for (int w = 1; w * 32 < NT; ++w) r = MAX ? imax(r, red[w]) : imin(r, red[w]);
  SYNC();
  return r;
}

// s[0] = tree_sum(s[0:n]) over the block: s has P = pow2_at_least(n) slots,
// the caller filled s[0:n] and synchronized.  Every thread returns s[0].
template <class T>
__device__ T block_tree(T* s, int n) {
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

// tree_sum of s[0:n] by one thread, in place in its P slots.
template <class T>
__device__ T seq_tree(T* s, int n) {
  const int P = pow2_at_least(n);
  for (int i = n; i < P; ++i) s[i] = T(0);
  for (int h = P / 2; h >= 1; h /= 2)
    for (int i = 0; i < h; ++i) s[i] = s[i] + s[i + h];
  return s[0];
}

// --- Givens rotations ---------------------------------------------------------

template <class T>
__device__ T hyp(T x, T y) {
  const T a = vabs(x), b = vabs(y);
  const T hi = pmax(a, b), lo = pmin(a, b);
  if (hi == T(0)) return hi;
  const T q = lo / hi;
  return hi * vsqrt(T(1) + q * q);
}

template <class T>
__device__ void givens(T f, T g, T& c, T& s, T& r) {
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

// A[i:i+2, j0:j1] = [c s; -s c] @ A[i:i+2, j0:j1] (row stride ld).
template <class T>
__device__ void lmul2(T* A, int ld, T c, T s, int i, int j0, int j1) {
  T* r1 = A + i * ld;
  T* r2 = r1 + ld;
  for (int j = j0 + TID; j < j1; j += NT) {
    const T a1 = r1[j], a2 = r2[j];
    r1[j] = c * a1 + s * a2;
    r2[j] = -s * a1 + c * a2;
  }
}

// A[r0:r1, i:i+2] = A[r0:r1, i:i+2] @ [c s; -s c]^T.
template <class T>
__device__ void rmul2(T* A, int ld, T c, T s, int i, int r0, int r1) {
  for (int r = r0 + TID; r < r1; r += NT) {
    T* a = A + r * ld + i;
    const T a1 = a[0], a2 = a[1];
    a[0] = a1 * c + a2 * s;
    a[1] = -a1 * s + a2 * c;
  }
}

template <class T>
__device__ void lmul3(T* A, int ld, T c1, T s1, T c2, T s2, int i, int j0, int j1) {
  T* q1 = A + i * ld;
  T* q2 = q1 + ld;
  T* q3 = q2 + ld;
  for (int j = j0 + TID; j < j1; j += NT) {
    const T a1 = q1[j], a2 = q2[j], a3 = q3[j];
    const T b2 = c1 * a2 + s1 * a3;
    const T b3 = -s1 * a2 + c1 * a3;
    q1[j] = c2 * a1 + s2 * b2;
    q2[j] = -s2 * a1 + c2 * b2;
    q3[j] = b3;
  }
}

template <class T>
__device__ void rmul3(T* A, int ld, T c1, T s1, T c2, T s2, int i, int r0, int r1) {
  for (int r = r0 + TID; r < r1; r += NT) {
    T* a = A + r * ld + i;
    const T a1 = a[0], a2 = a[1], a3 = a[2];
    const T b2 = a2 * c1 + a3 * s1;
    const T b3 = -a2 * s1 + a3 * c1;
    a[0] = a1 * c2 + b2 * s2;
    a[1] = -a1 * s2 + b2 * c2;
    a[2] = b3;
  }
}

// --- Francis QR (real quasi-Schur) ----------------------------------------------

template <class T>
__device__ void upper_triangular_2x2(T h11, T h12, T h21, T h22, bool& is_real,
                                     T& c, T& s) {
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
__device__ bool use_single_shift(T h11, T h12, T h21, T h22, T& mu) {
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
__device__ void rot3(T p1, T p2, T p3, T& c1, T& s1, T& c2, T& s2, T& n2) {
  T n1;
  givens(p2, p3, c1, s1, n1);
  givens(p1, n1, c2, s2, n2);
}

// The chase's steps after the first read column i-1 (which the left
// rotation does not touch), so the scalar writes of that column wait for
// the second phase and one barrier suffices before it.
template <class T>
__device__ void single_shift_sweep(T* H, T* Q, int m, int frm, int to, T mu) {
  T c, s, r;
  givens(H[frm * m + frm] - mu, H[(frm + 1) * m + frm], c, s, r);
  SYNC();
  lmul2(H, m, c, s, frm, frm, m);
  rmul2(Q, m, c, s, frm, 0, m);
  SYNC();
  rmul2(H, m, c, s, frm, 0, imin(frm + 3, m));
  SYNC();
  for (int i = frm + 1; i < to; ++i) {
    givens(H[i * m + i - 1], H[(i + 1) * m + i - 1], c, s, r);
    lmul2(H, m, c, s, i, i, m);
    rmul2(Q, m, c, s, i, 0, m);
    SYNC();
    rmul2(H, m, c, s, i, 0, imin(i + 3, m));
    if (TID == 0) {
      H[i * m + i - 1] = r;
      H[(i + 1) * m + i - 1] = T(0);
    }
    SYNC();
  }
}

template <class T>
__device__ void double_shift_sweep(T* H, T* Q, int m, int frm, int to, T trace,
                                   T det) {
  const T h11 = H[frm * m + frm], h21 = H[(frm + 1) * m + frm];
  const T h12 = H[frm * m + frm + 1], h22 = H[(frm + 1) * m + frm + 1];
  const T h32 = H[(frm + 2) * m + frm + 1];
  const T p1 = h11 * h11 + h12 * h21 - trace * h11 + det;
  const T p2 = h21 * (h11 + h22 - trace);
  const T p3 = h32 * h21;
  T c1, s1, c2, s2, r;
  rot3(p1, p2, p3, c1, s1, c2, s2, r);
  SYNC();
  lmul3(H, m, c1, s1, c2, s2, frm, frm, m);
  rmul3(Q, m, c1, s1, c2, s2, frm, 0, m);
  SYNC();
  rmul3(H, m, c1, s1, c2, s2, frm, 0, imin(frm + 4, m));
  SYNC();
  for (int i = frm + 1; i < to - 1; ++i) {
    rot3(H[i * m + i - 1], H[(i + 1) * m + i - 1], H[(i + 2) * m + i - 1], c1, s1,
         c2, s2, r);
    lmul3(H, m, c1, s1, c2, s2, i, i, m);
    rmul3(Q, m, c1, s1, c2, s2, i, 0, m);
    SYNC();
    rmul3(H, m, c1, s1, c2, s2, i, 0, imin(i + 4, m));
    if (TID == 0) {
      H[i * m + i - 1] = r;
      H[(i + 1) * m + i - 1] = T(0);
      H[(i + 2) * m + i - 1] = T(0);
    }
    SYNC();
  }
  T c, s;
  givens(H[(to - 1) * m + to - 2], H[to * m + to - 2], c, s, r);
  lmul2(H, m, c, s, to - 1, to - 1, m);
  rmul2(Q, m, c, s, to - 1, 0, m);
  SYNC();
  rmul2(H, m, c, s, to - 1, 0, imin(to + 1, m));
  if (TID == 0) {
    H[(to - 1) * m + to - 2] = r;
    H[to * m + to - 2] = T(0);
  }
  SYNC();
}

// Quasi-Schur form of the window [lo, hi) of H, accumulated into Q.
// Returns true when the window finished within maxiter QR iterations.
template <class T>
__device__ bool local_schur(T* H, T* Q, int m, int lo, int hi, T eps, int maxiter) {
  int to = hi - 1;
  int it = 0;
  while (to > lo && it < maxiter) {
    int mx = -1;
    for (int j = lo + TID; j < to; j += NT) {
      const T sub = vabs(H[(j + 1) * m + j]);
      const T d0 = vabs(H[j * m + j]), d1 = vabs(H[(j + 1) * m + j + 1]);
      if (sub <= eps * (d0 + d1)) mx = imax(mx, j);
    }
    mx = block_ext<true>(mx);
    const int frm = mx >= 0 ? mx + 1 : lo;
    if (mx >= 0) {
      if (TID == 0) H[frm * m + frm - 1] = T(0);
      SYNC();
    }
    if (frm == to) {
      to -= 1;
    } else if (frm + 1 == to) {
      const T c11 = H[(to - 1) * m + to - 1], c12 = H[(to - 1) * m + to];
      const T c21 = H[to * m + to - 1], c22 = H[to * m + to];
      bool is_real;
      T c, s;
      upper_triangular_2x2(c11, c12, c21, c22, is_real, c, s);
      SYNC();
      if (is_real) {
        lmul2(H, m, c, s, frm, frm, m);
        rmul2(Q, m, c, s, frm, 0, m);
        SYNC();
        rmul2(H, m, c, s, frm, 0, to + 1);
        SYNC();
        if (TID == 0) H[to * m + to - 1] = T(0);
        SYNC();
      }
      to -= 2;
    } else {
      const T c11 = H[(to - 1) * m + to - 1], c12 = H[(to - 1) * m + to];
      const T c21 = H[to * m + to - 1], c22 = H[to * m + to];
      T mu;
      if (use_single_shift(c11, c12, c21, c22, mu))
        single_shift_sweep(H, Q, m, frm, to, mu);
      else
        double_shift_sweep(H, Q, m, frm, to, c11 + c22, c11 * c22 - c12 * c21);
    }
    ++it;
  }
  return to <= lo;
}

// --- eigenvalues of the quasi-triangular form (split-complex) -------------------

// coupled[i] (i < m-1): H[i+1, i] is not negligible; starts[i]: a diagonal
// block starts at i (a pair's members do not chain).  Block-wide; ends
// synchronized.
template <class T>
__device__ void block_starts(const T* H, int m, T eps, int* coupled, int* starts) {
  for (int i = TID; i < m; i += NT) {
    coupled[i] = 0;
    if (i < m - 1) {
      const T d0 = vabs(H[i * m + i]), d1 = vabs(H[(i + 1) * m + i + 1]);
      coupled[i] = vabs(H[(i + 1) * m + i]) > eps * (d0 + d1);
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
__device__ void pair_values(const T* H, int m, int i, T& x, T& rr, T& y) {
  const T d = H[i * m + i];
  const bool last = i == m - 1;
  const T dn = last ? T(0) : H[(i + 1) * m + i + 1];
  const T sup = last ? T(0) : H[i * m + i + 1];
  const T sub = last ? T(0) : H[(i + 1) * m + i];
  x = (d + dn) / T(2);
  const T det = d * dn - sup * sub;
  const T disc = x * x - det;
  const T nd = -disc;
  y = vsqrt(nd < T(0) ? T(0) : nd);
  rr = vsqrt(disc < T(0) ? T(0) : disc);
}

// lam_re/lam_im of the m x m part of H; ends synchronized.
template <class T>
__device__ void eigenvalues(const T* H, int m, T eps, int* coupled, int* starts,
                            T* lre, T* lim) {
  block_starts(H, m, eps, coupled, starts);
  for (int i = TID; i < m; i += NT) {
    const bool pstart = starts[i] && coupled[i];
    const bool psecond = i > 0 && starts[i - 1] && coupled[i - 1];
    T x, rr, y;
    if (pstart) {
      pair_values(H, m, i, x, rr, y);
      lre[i] = x + rr;
      lim[i] = y;
    } else if (psecond) {
      pair_values(H, m, i - 1, x, rr, y);
      lre[i] = x - rr;
      lim[i] = -y;
    } else {
      lre[i] = H[i * m + i];
      lim[i] = T(0);
    }
  }
  SYNC();
}

// --- Ritz residuals by split-complex backward substitution ------------------------

template <class T>
__device__ void cdiv(T ar, T ai, T br, T bi, T& cr, T& ci) {
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

// |Q[m-1, :] y| for the unit eigenvector y of the block holding i, by one
// thread (x_re, x_im: m slots; ts: pow2_at_least(m) slots).
template <class T>
__device__ T residual(const T* H, const T* qrow, int m, int i, T* x_re, T* x_im,
                      T* ts) {
  const int j = (i < m - 1 && H[(i + 1) * m + i] != T(0)) ? i + 1 : i;
  const int jm1 = imax(j - 1, 0);
  const bool pair = j > 0 && H[j * m + jm1] != T(0);
  const T b11 = H[jm1 * m + jm1], b12 = H[jm1 * m + j];
  const T b21 = H[j * m + jm1], b22 = H[j * m + j];
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
      x_re[c] = -H[c * m + jm1] * xr - H[c * m + j];
      x_im[c] = -H[c * m + jm1] * xi;
    }
    x_re[j - 1] = xr;
    x_im[j - 1] = xi;
    k = j - 1;
  } else {
    for (int c = 0; c < j; ++c) x_re[c] = -H[c * m + j];
    k = j;
  }
  x_re[j] = T(1);
  while (k > 0) {
    if (k > 1 && vabs(H[(k - 1) * m + k - 2]) > T(0)) {
      const int i2 = k - 2;
      const T r11 = H[i2 * m + i2] - lr;
      const T r12 = H[i2 * m + k - 1];
      const T r21 = H[(k - 1) * m + i2];
      const T r22 = H[(k - 1) * m + k - 1] - lr;
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
        const T ca = H[c * m + i2], cb = H[c * m + k - 1];
        x_re[c] = x_re[c] - (ca * a1r + cb * a2r);
        x_im[c] = x_im[c] - (ca * a1i + cb * a2i);
      }
      x_re[i2] = a1r;
      x_im[i2] = a1i;
      x_re[k - 1] = a2r;
      x_im[k - 1] = a2i;
      k -= 2;
    } else {
      const T sr = H[(k - 1) * m + k - 1] - lr;
      const T si = -li;
      T vr = T(0), vi = T(0);
      if (!(sr == T(0) && si == T(0))) cdiv(x_re[k - 1], x_im[k - 1], sr, si, vr, vi);
      for (int c = 0; c < k - 1; ++c) {
        const T ca = H[c * m + k - 1];
        x_re[c] = x_re[c] - ca * vr;
        x_im[c] = x_im[c] - ca * vi;
      }
      x_re[k - 1] = vr;
      x_im[k - 1] = vi;
      k -= 1;
    }
  }
  for (int c = 0; c < m; ++c) ts[c] = x_re[c] * x_re[c] + x_im[c] * x_im[c];
  T nrm = vsqrt(seq_tree(ts, m));
  nrm = nrm == T(0) ? T(1) : nrm;
  for (int c = 0; c < m; ++c) ts[c] = qrow[c] * x_re[c];
  const T tr = seq_tree(ts, m) / nrm;
  for (int c = 0; c < m; ++c) ts[c] = qrow[c] * x_im[c];
  const T ti = seq_tree(ts, m) / nrm;
  return vsqrt(tr * tr + ti * ti);
}

// --- Sylvester swaps and Schur reordering ----------------------------------------

// Complete-pivoting elimination of the N x N system M x = b (N = 1, 2, 4)
// in the plain version's order; every thread solves it.  Returns singular.
template <class T>
__device__ bool solve_complete_pivot(T* M, T* x, int N) {
  int colperm[4] = {0, 1, 2, 3};
  bool singular = false;
  for (int k = 0; k < N - 1; ++k) {
    T best = T(-1);
    int bi = k, bj = k;
    for (int i = k; i < N; ++i)
      for (int j = k; j < N; ++j)
        if (vabs(M[i * N + j]) > best) {
          best = vabs(M[i * N + j]);
          bi = i;
          bj = j;
        }
    for (int c = 0; c < N; ++c) {
      const T t = M[k * N + c];
      M[k * N + c] = M[bi * N + c];
      M[bi * N + c] = t;
    }
    { const T t = x[k]; x[k] = x[bi]; x[bi] = t; }
    for (int r = 0; r < N; ++r) {
      const T t = M[r * N + k];
      M[r * N + k] = M[r * N + bj];
      M[r * N + bj] = t;
    }
    { const int t = colperm[k]; colperm[k] = colperm[bj]; colperm[bj] = t; }
    const T pivot = M[k * N + k];
    singular = singular || pivot == T(0);
    const T piv_s = pivot == T(0) ? T(1) : pivot;
    for (int r = k + 1; r < N; ++r) {
      const T fac = M[r * N + k] / piv_s;
      for (int c = k + 1; c < N; ++c) M[r * N + c] = M[r * N + c] - fac * M[k * N + c];
      M[r * N + k] = fac;
      x[r] = x[r] - fac * x[k];
    }
  }
  singular = singular || M[(N - 1) * N + N - 1] == T(0);
  for (int i = N - 1; i >= 0; --i) {
    T e[4];
    for (int c = 0; c < N; ++c) e[c] = c > i ? M[i * N + c] * x[c] : T(0);
    for (int h = N / 2; h >= 1; h /= 2)
      for (int c = 0; c < h; ++c) e[c] = e[c] + e[c + h];
    const T piv = M[i * N + i];
    x[i] = (x[i] - e[0]) / (piv == T(0) ? T(1) : piv);
  }
  T out[4];
  for (int r = 0; r < N; ++r) out[colperm[r]] = x[r];
  for (int r = 0; r < N; ++r) x[r] = out[r];
  return singular;
}

// X (p x q, column-major in X[a * p + c] = X[c, a]) solving
// A X - X B = C with A = H[i:i+p, i:i+p], B the q x q block after it and
// C = H[i:i+p, i+p:i+p+q].
template <class T>
__device__ bool sylv(const T* H, int m, int i, int p, int q, T* X) {
  const int N = p * q;
  T M[16];
  const int bo = i + p;
  for (int a = 0; a < q; ++a)
    for (int c = 0; c < p; ++c)
      for (int b = 0; b < q; ++b)
        for (int d = 0; d < p; ++d) {
          const T va = a == b ? H[(i + c) * m + i + d] : T(0);
          const T vb = c == d ? H[(bo + b) * m + bo + a] : T(0);
          M[(a * p + c) * N + b * p + d] = va - vb;
        }
  for (int a = 0; a < q; ++a)
    for (int c = 0; c < p; ++c) X[a * p + c] = H[(i + c) * m + bo + a];
  return solve_complete_pivot(M, X, N);
}

template <class T>
__device__ void swap11(T* H, T* Q, int m, int i) {
  const T r11 = H[i * m + i], r12 = H[i * m + i + 1], r22 = H[(i + 1) * m + i + 1];
  T c, s, r;
  givens(r12, r22 - r11, c, s, r);
  SYNC();
  lmul2(H, m, c, s, i, i + 2, m);
  rmul2(H, m, c, s, i, 0, i);
  rmul2(Q, m, c, s, i, 0, m);
  if (TID == 0) {
    H[i * m + i] = r22;
    H[(i + 1) * m + i + 1] = r11;
  }
  SYNC();
}

template <class T>
__device__ void swap12(T* H, T* Q, int m, int i) {
  T X[4];
  const bool singular = sylv(H, m, i, 1, 2, X);
  SYNC();
  if (singular) return;
  T c1, s1, c2, s2, r;
  givens(-X[0], T(1), c1, s1, r);  // X[0, 0]
  const T x22 = -s1 * -X[1];       // X[0, 1]
  givens(x22, T(1), c2, s2, r);
  lmul2(H, m, c1, s1, i, i, m);
  rmul2(Q, m, c1, s1, i, 0, m);
  SYNC();
  rmul2(H, m, c1, s1, i, 0, i + 3);
  SYNC();
  lmul2(H, m, c2, s2, i + 1, i, m);
  rmul2(Q, m, c2, s2, i + 1, 0, m);
  SYNC();
  rmul2(H, m, c2, s2, i + 1, 0, i + 3);
  SYNC();
  if (TID == 0) {
    H[(i + 2) * m + i] = T(0);
    H[(i + 2) * m + i + 1] = T(0);
  }
  SYNC();
}

template <class T>
__device__ void swap21(T* H, T* Q, int m, int i) {
  T X[4];
  const bool singular = sylv(H, m, i, 2, 1, X);
  SYNC();
  if (singular) return;
  T c1, s1, n1, c2, s2, r;
  givens(-X[1], T(1), c1, s1, n1);  // X[1, 0]
  givens(-X[0], n1, c2, s2, r);     // X[0, 0]
  lmul3(H, m, c1, s1, c2, s2, i, i, m);
  rmul3(Q, m, c1, s1, c2, s2, i, 0, m);
  SYNC();
  rmul3(H, m, c1, s1, c2, s2, i, 0, i + 3);
  SYNC();
  if (TID == 0) {
    H[(i + 1) * m + i] = T(0);
    H[(i + 2) * m + i] = T(0);
  }
  SYNC();
}

template <class T>
__device__ void swap22(T* H, T* Q, int m, int i) {
  T X[4];
  const bool singular = sylv(H, m, i, 2, 2, X);
  SYNC();
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
  lmul3(H, m, c1, s1, c2, s2, i, i, m);
  rmul3(Q, m, c1, s1, c2, s2, i, 0, m);
  SYNC();
  rmul3(H, m, c1, s1, c2, s2, i, 0, i + 4);
  SYNC();
  lmul3(H, m, c3, s3, c4, s4, i + 1, i, m);
  rmul3(Q, m, c3, s3, c4, s4, i + 1, 0, m);
  SYNC();
  rmul3(H, m, c3, s3, c4, s4, i + 1, 0, i + 4);
  SYNC();
  if (TID == 0) {
    H[(i + 2) * m + i] = T(0);
    H[(i + 3) * m + i] = T(0);
    H[(i + 2) * m + i + 1] = T(0);
    H[(i + 3) * m + i + 1] = T(0);
  }
  SYNC();
}

template <class T>
__device__ bool is_start_11(const T* H, int m, int i) {
  return i == m - 1 || H[imin(i + 1, m - 1) * m + i] == T(0);
}

template <class T>
__device__ bool is_end_11(const T* H, int m, int i) {
  return i == 0 || H[i * m + imax(i - 1, 0)] == T(0);
}

// Every swap starts by reading H and synchronizes before its first write,
// so the block decisions read before it are safe.
template <class T>
__device__ void swap(T* H, T* Q, int m, int i, bool curr_11, bool next_11) {
  if (curr_11 && next_11) swap11(H, Q, m, i);
  else if (curr_11) swap12(H, Q, m, i);
  else if (next_11) swap21(H, Q, m, i);
  else swap22(H, Q, m, i);
}

template <class T>
__device__ void rotate_right(T* H, T* Q, int m, int frm, int to) {
  int i = to;
  while (i > frm) {
    const bool curr_11 = is_start_11(H, m, i);
    const bool prev_11 = is_end_11(H, m, i - 1);
    const int j = prev_11 ? i - 1 : i - 2;
    swap(H, Q, m, j, prev_11, curr_11);
    i = j;
  }
}

template <class T>
__device__ void partition_three_way(T* H, T* Q, int m, const int* groups) {
  int hi = 0, mi = 0, lo = 0;
  while (hi < m) {
    const int group = groups[imin(hi, m - 1)];
    const int bs = is_start_11(H, m, hi) ? 1 : 2;
    if (group <= 1) {
      rotate_right(H, Q, m, lo, hi);
      lo += bs;
      mi += bs;
    } else if (group == 2) {
      rotate_right(H, Q, m, mi, hi);
      mi += bs;
    }
    hi += bs;
    SYNC();
  }
}

enum { LM = 0, LR = 1, SR = 2, LI = 3, SI = 4 };

template <class T>
__device__ T order_key(int which, T re, T im) {
  switch (which) {
    case LM: return -hyp(re, im);
    case LR: return -re;
    case SR: return re;
    case LI: return -im;
    default: return im;
  }
}

template <class T>
__device__ T block_eig_key(const T* H, int m, int i, int which) {
  if (is_start_11(H, m, i)) return order_key(which, H[i * m + i], T(0));
  const int i1 = imin(i + 1, m - 1);
  const T b11 = H[i * m + i], b12 = H[i * m + i1];
  const T b21 = H[i1 * m + i], b22 = H[i1 * m + i1];
  const T x = (b11 + b22) / T(2);
  const T disc = x * x - (b11 * b22 - b12 * b21);
  return order_key(which, x + vsqrt(pmax(disc, T(0))), vsqrt(pmax(-disc, T(0))));
}

template <class T>
__device__ void sort_schur(T* H, T* Q, int m, int count, int which) {
  int nxt = 0;
  while (nxt < count) {
    int curr = nxt;
    const int curr_size0 = is_start_11(H, m, curr) ? 1 : 2;
    const T key_curr = block_eig_key(H, m, curr, which);
    while (curr > 0) {
      const int prev_size = is_end_11(H, m, curr - 1) ? 1 : 2;
      const int prev = curr - prev_size;
      if (!(key_curr < block_eig_key(H, m, imax(prev, 0), which))) break;
      const int curr_size = is_start_11(H, m, curr) ? 1 : 2;
      swap(H, Q, m, prev, prev_size == 1, curr_size == 1);
      curr = prev;
    }
    nxt += curr_size0;
    SYNC();
  }
}

// --- Hessenberg restoration after truncation --------------------------------------

// Scratch of the restore: vaug, dv (m+1 each), d2 (m), and ts, the tree
// slots (a row of pow2_at_least(m) for each of m+1 rows, or of
// pow2_at_least(m+1) for each of m columns).
template <class T>
struct RestoreScratch {
  T* vaug;
  T* dv;
  T* d2;
  T* ts;
};

template <class T>
__device__ void restore_arnoldi(T* H, T* Q, int m, int lo, int hi,
                                RestoreScratch<T> w) {
  if (lo >= hi - 1) return;
  const int last = m - 1;
  T nrm = Q[last * m + lo];
  for (int i = lo; i < hi - 1; ++i) {
    T c, s, nrm2;
    givens(Q[last * m + i + 1], nrm, c, s, nrm2);
    const T ns = -s;
    rmul2(H, m, c, ns, i, 0, imin(i + 3, hi));
    SYNC();
    lmul2(H, m, c, ns, i, 0, hi);
    rmul2(Q, m, c, ns, i, 0, m);
    SYNC();
    nrm = nrm2;
  }
  if (TID == 0) H[hi * m + hi - 1] = Q[last * m + hi - 1] * H[m * m + m - 1];
  SYNC();

  const int P1 = pow2_at_least(m), P2 = pow2_at_least(m + 1);
  const int nsweeps = imax(hi - 1 - lo - 1, 0);
  for (int t = 0; t < nsweeps; ++t) {
    const int length = (hi - 1 - lo) - t;
    const int row = lo + length;
    const int lastc = row - 1;
    const T alpha = H[row * m + lastc];
    for (int c = TID; c < m; c += NT) {
      const T h = H[row * m + c];
      w.ts[c] = (c >= lo && c < lastc) ? h * h : T(0);
    }
    SYNC();
    const T xnrm2 = block_tree(w.ts, m);
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
        const T v = (c >= lo && c < lastc) ? H[row * m + c] / denom : T(0);
        w.vaug[c] = v + (c == lastc ? T(1) : T(0));
      }
    }
    SYNC();
    // Column-space application to H's rows [0, row).
    for (int r = TID; r <= m; r += NT) {
      T d = T(0);
      if (r < row) {
        T* s = w.ts + r * P1;
        for (int c = 0; c < m; ++c) s[c] = H[r * m + c] * w.vaug[c];
        d = tau * seq_tree(s, m);
      }
      w.dv[r] = d;
    }
    SYNC();
    for (int e = TID; e < (m + 1) * m; e += NT)
      H[e] = H[e] - w.dv[e / m] * w.vaug[e % m];
    SYNC();
    for (int c = TID; c < m; c += NT) {
      const T h = H[row * m + c];
      H[row * m + c] = (c >= lo && c < lastc) ? T(0) : (c == lastc ? beta_w : h);
    }
    SYNC();
    // Row-space application to H's columns [lo, hi).
    for (int c = TID; c < m; c += NT) {
      T d = T(0);
      if (c >= lo && c < hi) {
        T* s = w.ts + c * P2;
        for (int r = 0; r <= m; ++r) s[r] = w.vaug[r] * H[r * m + c];
        d = tau * seq_tree(s, m + 1);
      }
      w.d2[c] = d;
    }
    SYNC();
    for (int e = TID; e < (m + 1) * m; e += NT)
      H[e] = H[e] - w.vaug[e / m] * w.d2[e % m];
    // Column-space application to Q (every row).
    for (int r = TID; r < m; r += NT) {
      T* s = w.ts + r * P1;
      for (int c = 0; c < m; ++c) s[c] = Q[r * m + c] * w.vaug[c];
      w.dv[r] = tau * seq_tree(s, m);
    }
    SYNC();
    for (int e = TID; e < m * m; e += NT) Q[e] = Q[e] - w.dv[e / m] * w.vaug[e % m];
    SYNC();
  }
}

// --- the two kernels ----------------------------------------------------------------

// Slots of the int32 loop state (dense/device.py: STATE).
enum { S_ACTIVE = 0, S_PRODS, S_IT, S_PURGES, S_DONE, S_QR_OK, S_K, S_ROLLBACK };

__host__ __device__ inline long long tree_slots(int m) {
  const long long a = (long long)(m + 1) * pow2_at_least(m);
  const long long b = (long long)m * pow2_at_least(m + 1);
  const long long c = pow2_at_least((m + 1) * m);
  long long r = a > b ? a : b;
  return r > c ? r : c;
}

// The scratch a call needs: work (T) and iwork (int) element counts.
__host__ __device__ inline long long work_len(int m) {
  return 8LL * m + 3LL * (m + 1) + 2LL * m * m + tree_slots(m);
}
__host__ __device__ inline long long iwork_len(int m) { return 6LL * m; }

template <class T>
struct Work {
  T *lre, *lim, *rs, *rs2, *keys, *xre, *xim;
  RestoreScratch<T> rw;
  int *coupled, *starts, *order, *groups, *conv, *pairat;
  __device__ Work(T* w, int* iw, int m) {
    lre = w;
    lim = lre + m;
    rs = lim + m;
    rs2 = rs + m;
    keys = rs2 + m;
    rw.vaug = keys + 3 * m;
    rw.dv = rw.vaug + (m + 1);
    rw.d2 = rw.dv + (m + 1);
    xre = rw.d2 + (m + 1);
    xim = xre + (long long)m * m;
    rw.ts = xim + (long long)m * m;
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

template <class T>
__device__ void set_eye(T* A, int rows, int cols) {
  for (int e = TID; e < rows * cols; e += NT) A[e] = (e / cols == e % cols) ? T(1) : T(0);
}

template <class T>
__global__ void __launch_bounds__(1024)
restart_kernel(T* H, T* Q, T* Qbig, int* state, const T* flags, int* info,
               T* work, int* iwork, int m, int nev, int mindim, double tol_d,
               int restarts, int which, int maxiter) {
  // The last expansion range's breakdown flags: roll back at the first.
  int jb = m;
  for (int j = TID; j < m; j += NT)
    if (flags[j] != T(0)) jb = imin(jb, j);
  jb = block_ext<false>(jb);
  if (jb < m) {
    if (TID == 0) state[S_ROLLBACK] = jb;
    return;
  }
  const int active = state[S_ACTIVE];
  const int it = state[S_IT] + 1;
  const int purges = state[S_PURGES];
  const int prods = state[S_PRODS];
  const int qr_ok = state[S_QR_OK];
  Work<T> w(work, iwork, m);
  const T eps = eps_of<T>();

  set_eye(Q, m, m);
  SYNC();
  const bool ok = local_schur(H, Q, m, active, m, eps, maxiter);
  SYNC();
  eigenvalues(H, m, eps, w.coupled, w.starts, w.lre, w.lim);

  // Residuals, thread per Ritz position, then the Schur-coupling floor and
  // the max over each pair.
  const T hl = vabs(H[m * m + m - 1]);
  const T* qrow = Q + (m - 1) * m;
  const int P1 = pow2_at_least(m);
  for (int i = TID; i < m; i += NT)
    w.rs[i] = i >= active
                  ? residual(H, qrow, m, i, w.xre + (long long)i * m,
                             w.xim + (long long)i * m, w.rw.ts + (long long)i * P1) * hl
                  : T(0);
  SYNC();
  for (int i = TID; i < m; i += NT) {
    const T cp = hl * vabs(qrow[i]);
    w.rs2[i] = w.rs[i] > cp ? w.rs[i] : cp;
  }
  SYNC();
  for (int i = TID; i < m; i += NT) {
    const bool first = i < m - 1 && H[(i + 1) * m + i] != T(0);
    w.rs[i] = first ? (w.rs2[i + 1] > w.rs2[i] ? w.rs2[i + 1] : w.rs2[i]) : w.rs2[i];
  }
  SYNC();
  for (int i = TID; i < m; i += NT) {
    const bool second = i > 0 && H[i * m + i - 1] != T(0);
    w.rs2[i] = second ? (w.rs[i - 1] > w.rs[i] ? w.rs[i - 1] : w.rs[i]) : w.rs[i];
  }
  for (int e = TID; e < (m + 1) * m; e += NT) w.rw.ts[e] = H[e] * H[e];
  SYNC();
  const T hfrob = vsqrt(block_tree(w.rw.ts, (m + 1) * m));

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

  partition_three_way(H, Q, m, w.groups);
  SYNC();
  restore_arnoldi(H, Q, m, nlock, k, w.rw);
  SYNC();

  // Qbig: columns [purge, k) from Q's rows [purge, m); column k takes the
  // old row m; identity elsewhere.
  const int m1 = m + 1;
  for (int e = TID; e < m1 * m1; e += NT) {
    const int r = e / m1, c = e % m1;
    T v = r == c ? T(1) : T(0);
    if (c >= purge && c < k) v = (r >= purge && r < m) ? Q[r * m + c] : T(0);
    if (k < m && c == k) v = r == m ? T(1) : T(0);
    Qbig[e] = v;
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
  }
}

template <class T>
__global__ void __launch_bounds__(1024)
finish_kernel(T* H, T* Q, T* Qbig, T* lam, const int* state, T* work, int* iwork,
              int m, int which) {
  const int count = state[S_ACTIVE];
  Work<T> w(work, iwork, m);
  set_eye(Q, m, m);
  SYNC();
  sort_schur(H, Q, m, count, which);
  SYNC();
  const int m1 = m + 1;
  for (int e = TID; e < m1 * m1; e += NT) {
    const int r = e / m1, c = e % m1;
    Qbig[e] = (r < m && c < m) ? Q[r * m + c] : (r == c ? T(1) : T(0));
  }
  eigenvalues(H, m, eps_of<T>(), w.coupled, w.starts, lam, lam + m);
}

template <class T>
int launch_restart(void* H, void* Q, void* Qbig, void* state, const void* flags,
                   void* info, void* work, void* iwork, int m, int nev, int mindim,
                   double tol, int restarts, int which, int maxiter, int threads,
                   void* stream) {
  if (m < 2 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  restart_kernel<T><<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(H), static_cast<T*>(Q), static_cast<T*>(Qbig),
      static_cast<int*>(state), static_cast<const T*>(flags), static_cast<int*>(info),
      static_cast<T*>(work), static_cast<int*>(iwork), m, nev, mindim, tol, restarts,
      which, maxiter);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_finish(void* H, void* Q, void* Qbig, void* lam, const void* state,
                  void* work, void* iwork, int m, int which, int threads, void* stream) {
  if (m < 2 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  finish_kernel<T><<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(H), static_cast<T*>(Q), static_cast<T*>(Qbig), static_cast<T*>(lam),
      static_cast<const int*>(state), static_cast<T*>(work), static_cast<int*>(iwork), m,
      which);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long dense_restart_work_len(int m) { return work_len(m); }
long long dense_restart_iwork_len(int m) { return iwork_len(m); }

#define RESTART_ARGS                                                              \
  void *H, void *Q, void *Qbig, void *state, const void *flags, void *info,       \
      void *work, void *iwork, int m, int nev, int mindim, double tol,            \
      int restarts, int which, int maxiter, int threads, void *stream
#define RESTART_PASS                                                              \
  H, Q, Qbig, state, flags, info, work, iwork, m, nev, mindim, tol, restarts,     \
      which, maxiter, threads, stream
#define FINISH_ARGS                                                               \
  void *H, void *Q, void *Qbig, void *lam, const void *state, void *work,         \
      void *iwork, int m, int which, int threads, void *stream
#define FINISH_PASS H, Q, Qbig, lam, state, work, iwork, m, which, threads, stream

int dense_restart_f32(RESTART_ARGS) { return launch_restart<float>(RESTART_PASS); }
int dense_restart_f64(RESTART_ARGS) { return launch_restart<double>(RESTART_PASS); }
int dense_finish_f32(FINISH_ARGS) { return launch_finish<float>(FINISH_PASS); }
int dense_finish_f64(FINISH_ARGS) { return launch_finish<double>(FINISH_PASS); }

}  // extern "C"
