// arnoldi_dense.cpp — native host kernels for the Krylov-Schur restart.
//
// LAPACK/BLAS-free implementations of the small dense restart kernels:
// Francis QR on Hessenberg windows, Bai-Demmel Schur block swapping via
// tiny completely-pivoted Sylvester solves, Givens+Householder Hessenberg
// restoration, quasi-triangular eigenvalues/eigenvectors and Ritz
// residuals.  Semantics mirror the tested Python reference layer in
// arnoldimethod_tpu/dense/ (which in turn documents the behavioral spec,
// ArnoldiMethod.jl src/schurfact.jl, schursort.jl, restore_hessenberg.jl,
// eigvals.jl, eigenvector_uppertriangular.jl).
//
// All matrices are row-major double / complex<double> with an explicit
// leading dimension (row stride in elements).  The workspace Hessenberg is
// (m+1) x m; its square top block is addressed with ld = m.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libarnoldi_dense.so arnoldi_dense.cpp

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>

using std::abs;
using std::max;
using std::min;
using cplx = std::complex<double>;

namespace {

// ---------------------------------------------------------------------------
// Scalar helpers
// ---------------------------------------------------------------------------

inline double conj_(double x) { return x; }
inline cplx conj_(cplx x) { return std::conj(x); }
inline double real_(double x) { return x; }
inline double real_(cplx x) { return x.real(); }
inline bool is_zero(double x) { return x == 0.0; }
inline bool is_zero(cplx x) { return x == cplx(0.0, 0.0); }

template <typename T>
struct M {
  T* p;
  long ld;
  inline T& operator()(long i, long j) const { return p[i * ld + j]; }
};

// Robust plane rotation: [c s; -conj(s) c] [f; g] = [r; 0], c real.
inline void givens(double f, double g, double& c, double& s, double& r) {
  if (g == 0.0) { c = 1.0; s = 0.0; r = f; return; }
  if (f == 0.0) { c = 0.0; s = g > 0 ? 1.0 : -1.0; r = std::fabs(g); return; }
  double fa = std::fabs(f), ga = std::fabs(g);
  double scale = max(fa, ga);
  double fs = f / scale, gs = g / scale;
  double d = std::sqrt(fs * fs + gs * gs);
  double sgn = f > 0 ? 1.0 : -1.0;
  c = std::fabs(fs) / d;
  s = sgn * gs / d;
  r = sgn * d * scale;
}

inline void givens(cplx f, cplx g, double& c, cplx& s, cplx& r) {
  if (is_zero(g)) { c = 1.0; s = 0.0; r = f; return; }
  if (is_zero(f)) {
    double ga = abs(g);
    c = 0.0; s = std::conj(g) / ga; r = ga;
    return;
  }
  double fa = abs(f), ga = abs(g);
  double scale = max(fa, ga);
  cplx fs = f / scale, gs = g / scale;
  double d = std::sqrt(std::norm(fs) + std::norm(gs));
  cplx sgn = f / fa;
  c = abs(fs) / d;
  s = sgn * std::conj(gs) / d;
  r = sgn * (d * scale);
}

// ---------------------------------------------------------------------------
// Ranged rotation application (rows/cols i, i+1; half-open ranges)
// ---------------------------------------------------------------------------

template <typename T, typename S>
inline void lmul2(double c, S s, M<T> A, long i, long j0, long j1) {
  T* r1 = &A(i, 0);
  T* r2 = &A(i + 1, 0);
  for (long j = j0; j < j1; ++j) {
    T a1 = r1[j], a2 = r2[j];
    r1[j] = c * a1 + s * a2;
    r2[j] = -conj_(s) * a1 + c * a2;
  }
}

template <typename T, typename S>
inline void rmul2(M<T> A, double c, S s, long i, long r0, long r1) {
  for (long r = r0; r < r1; ++r) {
    T a1 = A(r, i), a2 = A(r, i + 1);
    A(r, i) = a1 * c + a2 * conj_(s);
    A(r, i + 1) = -(a1 * s) + a2 * c;
  }
}

template <typename T, typename S>
inline void lmul3(double c1, S s1, double c2, S s2, M<T> A, long i, long j0, long j1) {
  T* r1 = &A(i, 0);
  T* r2 = &A(i + 1, 0);
  T* r3 = &A(i + 2, 0);
  for (long j = j0; j < j1; ++j) {
    T a1 = r1[j], a2 = r2[j], a3 = r3[j];
    T b2 = c1 * a2 + s1 * a3;
    T b3 = -conj_(s1) * a2 + c1 * a3;
    r1[j] = c2 * a1 + s2 * b2;
    r2[j] = -conj_(s2) * a1 + c2 * b2;
    r3[j] = b3;
  }
}

template <typename T, typename S>
inline void rmul3(M<T> A, double c1, S s1, double c2, S s2, long i, long r0, long r1) {
  for (long r = r0; r < r1; ++r) {
    T a1 = A(r, i), a2 = A(r, i + 1), a3 = A(r, i + 2);
    T b2 = a2 * c1 + a3 * conj_(s1);
    T b3 = -(a2 * s1) + a3 * c1;
    A(r, i) = a1 * c2 + b2 * conj_(s2);
    A(r, i + 1) = -(a1 * s2) + b2 * c2;
    A(r, i + 2) = b3;
  }
}

// ---------------------------------------------------------------------------
// Francis QR (dense/schur.py)
// ---------------------------------------------------------------------------

template <typename T>
inline bool offdiag_small(M<T> H, long i, double tol) {
  return abs(H(i + 1, i)) <= tol * (abs(H(i, i)) + abs(H(i + 1, i + 1)));
}

inline double sign_(double x) { return x > 0 ? 1.0 : (x < 0 ? -1.0 : 0.0); }

// dlanv2-style analysis of a real 2x2 block; see dense/schur.py.
inline bool upper_triangular_2x2(double h11, double h12, double h21, double h22,
                                 double& c, double& s) {
  c = 1.0; s = 0.0;
  if (h21 == 0.0 || (h11 == h22 && sign_(h12) != sign_(h21))) return false;
  if (h12 == 0.0) { c = 0.0; s = 1.0; return true; }
  double p = (h11 - h22) / 2;
  double bcmax = max(std::fabs(h12), std::fabs(h21));
  double bcmis = min(std::fabs(h12), std::fabs(h21)) * sign_(h12) * sign_(h21);
  double scale = max(std::fabs(p), bcmax);
  double z = (p / scale) * p + (bcmax / scale) * bcmis;
  if (z < 0) return false;
  double h11ml = p + std::copysign(std::sqrt(scale) * std::sqrt(z), p);
  double nrm = std::hypot(h21, h11ml);
  c = h11ml / nrm;
  s = h21 / nrm;
  return true;
}

inline bool use_single_shift(double h11, double h12, double h21, double h22,
                             double& mu) {
  double scale = std::fabs(h11) + std::fabs(h12) + std::fabs(h21) + std::fabs(h22);
  double a11 = h11 / scale, a12 = h12 / scale, a21 = h21 / scale, a22 = h22 / scale;
  double t = (a11 + a22) / 2;
  double d = (a11 - t) * (a22 - t) - a12 * a21;
  mu = 0.0;
  if (d > 0) return false;
  double sq = std::sqrt(std::fabs(d));
  double l1 = t + sq, l2 = t - sq;
  double lam = std::fabs(a22 - l1) < std::fabs(a22 - l2) ? l1 : l2;
  mu = lam * scale;
  return true;
}

template <typename T, typename S>
void single_shift_qr(M<T> H, long m_rows, long n, long frm, long to, T mu,
                     M<T>* Q, long qrows) {
  double c; S s; S r;
  givens(H(frm, frm) - mu, H(frm + 1, frm), c, s, r);
  lmul2(c, s, H, frm, frm, n);
  rmul2(H, c, s, frm, 0L, min(frm + 3, m_rows));
  if (Q) rmul2(*Q, c, s, frm, 0L, qrows);
  for (long i = frm + 1; i < to; ++i) {
    givens(H(i, i - 1), H(i + 1, i - 1), c, s, r);
    H(i, i - 1) = r;
    H(i + 1, i - 1) = T(0);
    lmul2(c, s, H, i, i, n);
    rmul2(H, c, s, i, 0L, min(i + 3, m_rows));
    if (Q) rmul2(*Q, c, s, i, 0L, qrows);
  }
}

void double_shift_qr(M<double> H, long m_rows, long n, long frm, long to,
                     double trace, double det, M<double>* Q, long qrows) {
  double h11 = H(frm, frm), h21 = H(frm + 1, frm);
  double h12 = H(frm, frm + 1), h22 = H(frm + 1, frm + 1);
  double h32 = H(frm + 2, frm + 1);
  double p1 = h11 * h11 + h12 * h21 - trace * h11 + det;
  double p2 = h21 * (h11 + h22 - trace);
  double p3 = h32 * h21;

  double c1, s1, c2, s2, n1, n2;
  givens(p2, p3, c1, s1, n1);
  givens(p1, n1, c2, s2, n2);
  lmul3(c1, s1, c2, s2, H, frm, frm, n);
  rmul3(H, c1, s1, c2, s2, frm, 0L, min(frm + 4, m_rows));
  if (Q) rmul3(*Q, c1, s1, c2, s2, frm, 0L, qrows);

  for (long i = frm + 1; i < to - 1; ++i) {
    givens(H(i + 1, i - 1), H(i + 2, i - 1), c1, s1, n1);
    givens(H(i, i - 1), n1, c2, s2, n2);
    H(i, i - 1) = n2;
    H(i + 1, i - 1) = 0.0;
    H(i + 2, i - 1) = 0.0;
    lmul3(c1, s1, c2, s2, H, i, i, n);
    rmul3(H, c1, s1, c2, s2, i, 0L, min(i + 4, m_rows));
    if (Q) rmul3(*Q, c1, s1, c2, s2, i, 0L, qrows);
  }

  double c, s, r;
  givens(H(to - 1, to - 2), H(to, to - 2), c, s, r);
  H(to - 1, to - 2) = r;
  H(to, to - 2) = 0.0;
  lmul2(c, s, H, to - 1, to - 1, n);
  rmul2(H, c, s, to - 1, 0L, min(to + 1, m_rows));
  if (Q) rmul2(*Q, c, s, to - 1, 0L, qrows);
}

int local_schur_real(M<double> H, long m_rows, long n, long lo, long hi,
                     M<double>* Q, long qrows, double tol, long maxiter) {
  long to = hi - 1;
  long it = 0;
  while (to > lo) {
    if (++it > maxiter) return 0;  // non-convergence
    long frm = to;
    while (frm > lo) {
      if (offdiag_small(H, frm - 1, tol)) {
        H(frm, frm - 1) = 0.0;
        break;
      }
      --frm;
    }
    if (frm == to) { --to; continue; }

    double c11 = H(to - 1, to - 1), c12 = H(to - 1, to);
    double c21 = H(to, to - 1), c22 = H(to, to);

    if (frm + 1 == to) {
      double c, s;
      if (upper_triangular_2x2(c11, c12, c21, c22, c, s)) {
        lmul2(c, s, H, frm, frm, n);
        rmul2(H, c, s, frm, 0L, to + 1);
        if (Q) rmul2(*Q, c, s, frm, 0L, qrows);
        H(to, to - 1) = 0.0;
      }
      to -= 2;
      continue;
    }

    double mu;
    if (use_single_shift(c11, c12, c21, c22, mu)) {
      single_shift_qr<double, double>(H, m_rows, n, frm, to, mu, Q, qrows);
    } else {
      double_shift_qr(H, m_rows, n, frm, to, c11 + c22, c11 * c22 - c12 * c21,
                      Q, qrows);
    }
  }
  return 1;
}

int local_schur_cplx(M<cplx> H, long m_rows, long n, long lo, long hi,
                     M<cplx>* Q, long qrows, double tol, long maxiter) {
  long to = hi - 1;
  long it = 0;
  while (true) {
    if (++it > maxiter) return 0;
    long frm = to;
    while (frm > lo && !offdiag_small(H, frm - 1, tol)) --frm;
    if (frm == to) {
      if (frm > 0) H(frm, frm - 1) = 0.0;
      --to;
    } else {
      cplx h11 = H(to - 1, to - 1), h12 = H(to - 1, to);
      cplx h21 = H(to, to - 1), h22 = H(to, to);
      cplx d = h11 * h22 - h21 * h12;
      cplx t = h11 + h22;
      cplx sq = std::sqrt(t * t - 4.0 * d);
      cplx l1 = (t + sq) / 2.0, l2 = (t - sq) / 2.0;
      cplx lam = abs(h22 - l1) < abs(h22 - l2) ? l1 : l2;
      single_shift_qr<cplx, cplx>(H, m_rows, n, frm, to, lam, Q, qrows);
    }
    if (to <= lo) break;
  }
  return 1;
}

// ---------------------------------------------------------------------------
// Sylvester solves + block swapping (dense/sylvester.py, dense/swaps.py)
// ---------------------------------------------------------------------------

// Complete-pivoting solve of an N<=4 system; returns false if singular.
template <typename T>
bool solve_cp(T* Mm, T* b, long N) {
  long colperm[4];
  for (long i = 0; i < N; ++i) colperm[i] = i;
  auto MM = [&](long i, long j) -> T& { return Mm[i * N + j]; };
  for (long k = 0; k < N - 1; ++k) {
    long pi = k, pj = k;
    double best = -1.0;
    for (long i = k; i < N; ++i)
      for (long j = k; j < N; ++j)
        if (abs(MM(i, j)) > best) { best = abs(MM(i, j)); pi = i; pj = j; }
    for (long j = k; j < N; ++j) std::swap(MM(k, j), MM(pi, j));
    std::swap(b[k], b[pi]);
    for (long i = 0; i < N; ++i) std::swap(MM(i, k), MM(i, pj));
    std::swap(colperm[k], colperm[pj]);
    T pivot = MM(k, k);
    if (is_zero(pivot)) return false;
    for (long i = k + 1; i < N; ++i) {
      MM(i, k) = MM(i, k) / pivot;
      for (long j = k + 1; j < N; ++j) MM(i, j) -= MM(i, k) * MM(k, j);
      b[i] -= MM(i, k) * b[k];
    }
  }
  if (is_zero(MM(N - 1, N - 1))) return false;
  for (long i = N - 1; i >= 0; --i) {
    for (long j = i + 1; j < N; ++j) b[i] -= MM(i, j) * b[j];
    b[i] = b[i] / MM(i, i);
  }
  T out[4];
  for (long i = 0; i < N; ++i) out[colperm[i]] = b[i];
  std::memcpy(b, out, N * sizeof(T));
  return true;
}

// Solve A X - X B = C (A pxp, B qxq, C/X pxq, p,q <= 2), column-stacked.
template <typename T>
bool sylv(const T* A, long p, const T* B, long q, const T* C, T* X) {
  long N = p * q;
  T Mm[16];
  T b[4];
  // M = kron(I_q, A) - kron(B^T, I_p), vec column-stacked: index (i + p*j).
  for (long j2 = 0; j2 < q; ++j2)
    for (long i2 = 0; i2 < p; ++i2)
      for (long j1 = 0; j1 < q; ++j1)
        for (long i1 = 0; i1 < p; ++i1) {
          T v = T(0);
          if (j1 == j2) v += A[i1 * p + i2];
          if (i1 == i2) v -= B[j2 * q + j1];
          Mm[(i1 + p * j1) * N + (i2 + p * j2)] = v;
        }
  for (long j = 0; j < q; ++j)
    for (long i = 0; i < p; ++i) b[i + p * j] = C[i * q + j];
  if (!solve_cp(Mm, b, N)) return false;
  for (long j = 0; j < q; ++j)
    for (long i = 0; i < p; ++i) X[i * q + j] = b[i + p * j];
  return true;
}

template <typename T, typename S>
void swap22(M<T> R, long n_cols, long i, M<T>* Q, long qrows) {
  T A[4] = {R(i, i), R(i, i + 1), R(i + 1, i), R(i + 1, i + 1)};
  T B[4] = {R(i + 2, i + 2), R(i + 2, i + 3), R(i + 3, i + 2), R(i + 3, i + 3)};
  T C[4] = {R(i, i + 2), R(i, i + 3), R(i + 1, i + 2), R(i + 1, i + 3)};
  T X[4];
  if (!sylv(A, 2, B, 2, C, X)) return;
  double c1, c2, c3, c4;
  S s1, s2, s3, s4, n1, n3, tmp;
  givens(-X[2], T(1), c1, s1, n1);          // X[1,0]
  givens(-X[0], T(n1), c2, s2, tmp);        // X[0,0]
  T x22 = c1 * -X[3];
  T x32 = -conj_(s1) * -X[3];
  x22 = -conj_(s2) * -X[1] + c2 * x22;
  givens(T(x32), T(1), c3, s3, n3);
  givens(T(x22), T(n3), c4, s4, tmp);

  lmul3(c1, s1, c2, s2, R, i, i, n_cols);
  rmul3(R, c1, s1, c2, s2, i, 0L, i + 4);
  lmul3(c3, s3, c4, s4, R, i + 1, i, n_cols);
  rmul3(R, c3, s3, c4, s4, i + 1, 0L, i + 4);
  R(i + 2, i) = T(0);
  R(i + 3, i) = T(0);
  R(i + 2, i + 1) = T(0);
  R(i + 3, i + 1) = T(0);
  if (Q) {
    rmul3(*Q, c1, s1, c2, s2, i, 0L, qrows);
    rmul3(*Q, c3, s3, c4, s4, i + 1, 0L, qrows);
  }
}

template <typename T, typename S>
void swap21(M<T> R, long n_cols, long i, M<T>* Q, long qrows) {
  T A[4] = {R(i, i), R(i, i + 1), R(i + 1, i), R(i + 1, i + 1)};
  T B[1] = {R(i + 2, i + 2)};
  T C[2] = {R(i, i + 2), R(i + 1, i + 2)};
  T X[2];
  if (!sylv(A, 2, B, 1, C, X)) return;
  double c1, c2;
  S s1, s2, n1, tmp;
  givens(-X[1], T(1), c1, s1, n1);
  givens(-X[0], T(n1), c2, s2, tmp);
  lmul3(c1, s1, c2, s2, R, i, i, n_cols);
  rmul3(R, c1, s1, c2, s2, i, 0L, i + 3);
  R(i + 1, i) = T(0);
  R(i + 2, i) = T(0);
  if (Q) rmul3(*Q, c1, s1, c2, s2, i, 0L, qrows);
}

template <typename T, typename S>
void swap12(M<T> R, long n_cols, long i, M<T>* Q, long qrows) {
  T A[1] = {R(i, i)};
  T B[4] = {R(i + 1, i + 1), R(i + 1, i + 2), R(i + 2, i + 1), R(i + 2, i + 2)};
  T C[2] = {R(i, i + 1), R(i, i + 2)};
  T X[2];
  if (!sylv(A, 1, B, 2, C, X)) return;
  double c1, c2;
  S s1, s2, tmp;
  givens(-X[0], T(1), c1, s1, tmp);
  T x22 = -conj_(s1) * -X[1];
  givens(T(x22), T(1), c2, s2, tmp);
  lmul2(c1, s1, R, i, i, n_cols);
  rmul2(R, c1, s1, i, 0L, i + 3);
  lmul2(c2, s2, R, i + 1, i, n_cols);
  rmul2(R, c2, s2, i + 1, 0L, i + 3);
  R(i + 2, i) = T(0);
  R(i + 2, i + 1) = T(0);
  if (Q) {
    rmul2(*Q, c1, s1, i, 0L, qrows);
    rmul2(*Q, c2, s2, i + 1, 0L, qrows);
  }
}

template <typename T, typename S>
void swap11(M<T> R, long n_cols, long i, M<T>* Q, long qrows) {
  T r11 = R(i, i), r12 = R(i, i + 1), r22 = R(i + 1, i + 1);
  double c;
  S s, tmp;
  givens(r12, r22 - r11, c, s, tmp);
  lmul2(c, s, R, i, i + 2, n_cols);
  rmul2(R, c, s, i, 0L, i);
  R(i, i) = r22;
  R(i + 1, i + 1) = r11;
  if (Q) rmul2(*Q, c, s, i, 0L, qrows);
}

template <typename T>
inline bool start11(M<T> R, long n_cols, long i) {
  return i == n_cols - 1 || is_zero(R(i + 1, i));
}
template <typename T>
inline bool end11(M<T> R, long i) {
  return i == 0 || is_zero(R(i, i - 1));
}

template <typename T, typename S>
void swap_blocks(M<T> R, long n_cols, long i, bool cur11, bool nxt11, M<T>* Q,
                 long qrows) {
  if (cur11) {
    if (nxt11) swap11<T, S>(R, n_cols, i, Q, qrows);
    else swap12<T, S>(R, n_cols, i, Q, qrows);
  } else {
    if (nxt11) swap21<T, S>(R, n_cols, i, Q, qrows);
    else swap22<T, S>(R, n_cols, i, Q, qrows);
  }
}

template <typename T, typename S>
void rotate_right(M<T> R, long n_cols, long frm, long to, M<T>* Q, long qrows) {
  long i = to;
  while (i > frm) {
    bool cur11 = start11(R, n_cols, i);
    bool prev11 = end11(R, i - 1);
    long j = prev11 ? i - 1 : i - 2;
    swap_blocks<T, S>(R, n_cols, j, prev11, cur11, Q, qrows);
    i = j;
  }
}

template <typename T, typename S>
void partition_three_way(M<T> R, long m, M<T>* Q, long qrows,
                         const int64_t* groups) {
  long hi = 0, mi = 0, lo = 0;
  while (hi < m) {
    long g = groups[hi];
    long bs = start11(R, m, hi) ? 1 : 2;
    if (g == 3) {
      hi += bs;
    } else if (g == 2) {
      rotate_right<T, S>(R, m, mi, hi, Q, qrows);
      hi += bs; mi += bs;
    } else {
      rotate_right<T, S>(R, m, lo, hi, Q, qrows);
      hi += bs; mi += bs; lo += bs;
    }
  }
}

// ---------------------------------------------------------------------------
// Eigenvalues / ordering / sort (dense/eig.py + driver._sort_schur)
// ---------------------------------------------------------------------------

template <typename T>
cplx block_eigenvalue(M<T> R, long n_cols, long i);

template <>
cplx block_eigenvalue<double>(M<double> R, long n_cols, long i) {
  if (i == n_cols - 1 || R(i + 1, i) == 0.0) return cplx(R(i, i), 0.0);
  double d = R(i, i) * R(i + 1, i + 1) - R(i, i + 1) * R(i + 1, i);
  double x = (R(i, i) + R(i + 1, i + 1)) / 2;
  cplx y = std::sqrt(cplx(x * x - d, 0.0));
  return cplx(x, 0.0) + y;
}

template <>
cplx block_eigenvalue<cplx>(M<cplx> R, long n_cols, long i) {
  if (i == n_cols - 1 || is_zero(R(i + 1, i))) return R(i, i);
  cplx d = R(i, i) * R(i + 1, i + 1) - R(i, i + 1) * R(i + 1, i);
  cplx x = (R(i, i) + R(i + 1, i + 1)) / 2.0;
  cplx y = std::sqrt(x * x - d);
  return x + y;
}

// Ordering key: 0=LM, 1=LR, 2=SR, 3=LI, 4=SI; smaller = more wanted.
inline double order_key(int which, cplx lam) {
  switch (which) {
    case 0: return -abs(lam);
    case 1: return -lam.real();
    case 2: return lam.real();
    case 3: return -lam.imag();
    default: return lam.imag();
  }
}

template <typename T, typename S>
void sort_schur(M<T> R, long m, M<T>* Q, long qrows, long count, int which) {
  if (count <= 1) return;
  long next = 0;
  while (next < count) {
    long cur = next;
    long cur_size = start11(R, m, cur) ? 1 : 2;
    double key_cur = order_key(which, block_eigenvalue<T>(R, m, cur));
    while (cur > 0) {
      long prev_size = end11(R, cur - 1) ? 1 : 2;
      long prev = cur - prev_size;
      double key_prev = order_key(which, block_eigenvalue<T>(R, m, prev));
      if (!(key_cur < key_prev)) break;
      swap_blocks<T, S>(R, m, prev, prev_size == 1, cur_size == 1, Q, qrows);
      cur -= prev_size;
    }
    next += cur_size;
  }
}

// ---------------------------------------------------------------------------
// Hessenberg restore (dense/restore.py)
// ---------------------------------------------------------------------------

// clarfg-style reflector: maps y (len k) to beta e_k; returns conj(tau).
template <typename T>
T reflector(T* y, long k) {
  double xnrm2 = 0.0;
  for (long i = 0; i < k - 1; ++i) xnrm2 += std::norm(cplx(y[i]));
  T alpha = y[k - 1];
  if (xnrm2 == 0.0 && cplx(alpha).imag() == 0.0) return T(0);
  double beta = -std::copysign(std::hypot(abs(alpha), std::sqrt(xnrm2)),
                               real_(alpha));
  T tau = (T(beta) - alpha) / T(beta);
  T inv = T(1) / (alpha - T(beta));
  for (long i = 0; i < k - 1; ++i) y[i] = y[i] * inv;
  y[k - 1] = T(beta);
  return conj_(tau);
}

template <typename T>
void refl_lmul(const T* v, long lenv, T tau, long offset, M<T> H, long j0, long j1) {
  if (is_zero(tau)) return;
  for (long col = j0; col < j1; ++col) {
    T d = H(offset + lenv, col);
    for (long i = 0; i < lenv; ++i) d += conj_(v[i]) * H(offset + i, col);
    d = tau * d;
    for (long i = 0; i < lenv; ++i) H(offset + i, col) -= d * v[i];
    H(offset + lenv, col) -= d;
  }
}

template <typename T>
void refl_rmul(M<T> H, const T* v, long lenv, T tau, long offset, long r0, long r1) {
  if (is_zero(tau)) return;
  T ct = conj_(tau);
  for (long r = r0; r < r1; ++r) {
    T d = H(r, offset + lenv);
    for (long i = 0; i < lenv; ++i) d += H(r, offset + i) * v[i];
    d = ct * d;
    for (long i = 0; i < lenv; ++i) H(r, offset + i) -= d * conj_(v[i]);
    H(r, offset + lenv) -= d;
  }
}

template <typename T, typename S>
void restore_arnoldi(M<T> H, long rows, long cols, M<T> Q, long qrows, long lo,
                     long hi) {
  if (lo >= hi - 1) return;
  long last = qrows - 1;

  S nrm_s;
  double c;
  {
    // Givens pass zeroing Q[last, lo:hi-1]; rotations use (c, -s).
    T nrm = Q(last, lo);
    for (long i = lo; i < hi - 1; ++i) {
      S s, r;
      T f = Q(last, i + 1);
      givens(T(f), T(nrm), c, s, r);
      nrm = T(r);
      S ms = -s;
      rmul2(H, c, ms, i, 0L, min(i + 3, hi));
      lmul2(c, ms, H, i, 0L, hi);
      rmul2(Q, c, ms, i, 0L, qrows);
    }
  }
  (void)nrm_s;

  H(hi, hi - 1) = Q(last, hi - 1) * H(rows - 1, cols - 1);

  T ybuf[512];
  for (long len = hi - 1 - lo; len >= 2; --len) {
    long row = lo + len;
    for (long j = 0; j < len; ++j) ybuf[j] = conj_(H(row, lo + j));
    T tau = reflector(ybuf, len);
    refl_rmul(H, ybuf, len - 1, tau, lo, 0L, row);
    for (long j = 0; j < len - 1; ++j) H(row, lo + j) = T(0);
    H(row, lo + len - 1) = conj_(ybuf[len - 1]);
    refl_lmul(ybuf, len - 1, tau, lo, H, lo, hi);
    refl_rmul(Q, ybuf, len - 1, tau, lo, 0L, qrows);
  }
}

// ---------------------------------------------------------------------------
// Eigenvalues of the quasi-triangular form, eigenvectors, Ritz residuals
// (dense/eig.py + driver._copy_residuals)
// ---------------------------------------------------------------------------

template <typename T>
void copy_eigenvalues(M<T> R, long lo, long hi, double tol, cplx* out) {
  long i = lo;
  while (i < hi - 1) {
    if (offdiag_small(R, i, tol)) {
      out[i] = cplx(R(i, i));
      ++i;
    } else {
      cplx d = cplx(R(i, i)) * cplx(R(i + 1, i + 1)) -
               cplx(R(i, i + 1)) * cplx(R(i + 1, i));
      cplx x = (cplx(R(i, i)) + cplx(R(i + 1, i + 1))) / 2.0;
      cplx y = std::sqrt(x * x - d);
      out[i] = x + y;
      out[i + 1] = x - y;
      i += 2;
    }
  }
  if (i == hi - 1) out[i] = cplx(R(i, i));
}

// Shifted backward substitution; real quasi-triangular R, complex x.
inline void shifted_backward_sub(const M<double> R, cplx lam, cplx* x, long k) {
  while (k > 0) {
    if (k > 1 && R(k - 1, k - 2) != 0.0) {
      cplx r11 = R(k - 2, k - 2) - lam, r12 = R(k - 2, k - 1);
      cplx r21 = R(k - 1, k - 2), r22 = R(k - 1, k - 1) - lam;
      cplx det = r11 * r22 - r21 * r12;
      cplx a1 = (r22 * x[k - 2] - r12 * x[k - 1]) / det;
      cplx a2 = (-r21 * x[k - 2] + r11 * x[k - 1]) / det;
      x[k - 2] = a1;
      x[k - 1] = a2;
      for (long i = 0; i < k - 2; ++i)
        x[i] -= R(i, k - 2) * a1 + R(i, k - 1) * a2;
      k -= 2;
    } else {
      cplx sigma = R(k - 1, k - 1) - lam;
      if (sigma == cplx(0.0)) {
        x[k - 1] = 0.0;
      } else {
        x[k - 1] = x[k - 1] / sigma;
        for (long i = 0; i < k - 1; ++i) x[i] -= R(i, k - 1) * x[k - 1];
      }
      --k;
    }
  }
}

inline void shifted_backward_sub(const M<cplx> R, cplx lam, cplx* x, long k) {
  while (k > 0) {
    cplx sigma = R(k - 1, k - 1) - lam;
    if (sigma == cplx(0.0)) {
      x[k - 1] = 0.0;
    } else {
      x[k - 1] = x[k - 1] / sigma;
      for (long i = 0; i < k - 1; ++i) x[i] -= R(i, k - 1) * x[k - 1];
    }
    --k;
  }
}

// Returns count of valid entries; real path handles conjugate 2x2 blocks.
long collect_eigen(const M<double> R, long n_cols, long j, cplx* x) {
  if (j < n_cols - 1 && R(j + 1, j) != 0.0) ++j;
  if (j > 0 && R(j, j - 1) != 0.0) {
    double r11 = R(j - 1, j - 1), r21 = R(j, j - 1);
    double r12 = R(j - 1, j), r22 = R(j, j);
    double det = r11 * r22 - r21 * r12;
    double tr = r11 + r22;
    cplx lam = (cplx(tr) + std::sqrt(cplx(tr * tr - 4 * det))) / 2.0;
    x[j - 1] = cplx(-r12) / (cplx(r11) - lam);
    x[j] = 1.0;
    for (long i = 0; i < j - 1; ++i)
      x[i] = -R(i, j - 1) * x[j - 1] - R(i, j);
    shifted_backward_sub(R, lam, x, j - 1);
  } else {
    cplx lam = R(j, j);
    x[j] = 1.0;
    for (long i = 0; i < j; ++i) x[i] = -R(i, j);
    shifted_backward_sub(R, lam, x, j);
  }
  long k = j + 1;
  double nrm = 0.0;
  for (long i = 0; i < k; ++i) nrm += std::norm(x[i]);
  double inv = 1.0 / std::sqrt(nrm);
  for (long i = 0; i < k; ++i) x[i] *= inv;
  return k;
}

long collect_eigen(const M<cplx> R, long n_cols, long j, cplx* x) {
  (void)n_cols;
  cplx lam = R(j, j);
  x[j] = 1.0;
  for (long i = 0; i < j; ++i) x[i] = -R(i, j);
  shifted_backward_sub(R, lam, x, j);
  long k = j + 1;
  double nrm = 0.0;
  for (long i = 0; i < k; ++i) nrm += std::norm(x[i]);
  double inv = 1.0 / std::sqrt(nrm);
  for (long i = 0; i < k; ++i) x[i] *= inv;
  return k;
}

template <typename T>
void copy_residuals(const M<T> H, long m, const M<T> Q, T h_last, long lo,
                    long hi, double* rs, cplx* xbuf) {
  for (long i = 0; i < m; ++i) rs[i] = 0.0;
  for (long i = lo; i < hi; ++i) {
    for (long t = 0; t < m; ++t) xbuf[t] = 0.0;
    long klen = collect_eigen(H, m, i, xbuf);
    cplx tmp = 0.0;
    for (long t = 0; t < klen; ++t) tmp += cplx(Q(m - 1, t)) * xbuf[t];
    rs[i] = abs(tmp * cplx(h_last));
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

int am_local_schur_d(double* H, long ld, long m_rows, long n, long lo, long hi,
                     double* Q, long qld, long qrows, double tol, long maxiter) {
  M<double> Hm{H, ld};
  if (Q) {
    M<double> Qm{Q, qld};
    return local_schur_real(Hm, m_rows, n, lo, hi, &Qm, qrows, tol, maxiter);
  }
  return local_schur_real(Hm, m_rows, n, lo, hi, nullptr, 0, tol, maxiter);
}

int am_local_schur_z(cplx* H, long ld, long m_rows, long n, long lo, long hi,
                     cplx* Q, long qld, long qrows, double tol, long maxiter) {
  M<cplx> Hm{H, ld};
  if (Q) {
    M<cplx> Qm{Q, qld};
    return local_schur_cplx(Hm, m_rows, n, lo, hi, &Qm, qrows, tol, maxiter);
  }
  return local_schur_cplx(Hm, m_rows, n, lo, hi, nullptr, 0, tol, maxiter);
}

void am_partition_d(double* R, long ld, long m, double* Q, long qld, long qrows,
                    const int64_t* groups) {
  M<double> Rm{R, ld};
  M<double> Qm{Q, qld};
  partition_three_way<double, double>(Rm, m, &Qm, qrows, groups);
}

void am_partition_z(cplx* R, long ld, long m, cplx* Q, long qld, long qrows,
                    const int64_t* groups) {
  M<cplx> Rm{R, ld};
  M<cplx> Qm{Q, qld};
  partition_three_way<cplx, cplx>(Rm, m, &Qm, qrows, groups);
}

void am_sort_schur_d(double* R, long ld, long m, double* Q, long qld,
                     long qrows, long count, int which) {
  M<double> Rm{R, ld};
  M<double> Qm{Q, qld};
  sort_schur<double, double>(Rm, m, &Qm, qrows, count, which);
}

void am_sort_schur_z(cplx* R, long ld, long m, cplx* Q, long qld, long qrows,
                     long count, int which) {
  M<cplx> Rm{R, ld};
  M<cplx> Qm{Q, qld};
  sort_schur<cplx, cplx>(Rm, m, &Qm, qrows, count, which);
}

void am_restore_d(double* H, long ld, long rows, long cols, double* Q, long qld,
                  long qrows, long lo, long hi) {
  M<double> Hm{H, ld};
  M<double> Qm{Q, qld};
  restore_arnoldi<double, double>(Hm, rows, cols, Qm, qrows, lo, hi);
}

void am_restore_z(cplx* H, long ld, long rows, long cols, cplx* Q, long qld,
                  long qrows, long lo, long hi) {
  M<cplx> Hm{H, ld};
  M<cplx> Qm{Q, qld};
  restore_arnoldi<cplx, cplx>(Hm, rows, cols, Qm, qrows, lo, hi);
}

void am_eigvals_d(const double* R, long ld, long lo, long hi, double tol,
                  double* out_re, double* out_im) {
  M<double> Rm{const_cast<double*>(R), ld};
  cplx buf[512];
  copy_eigenvalues(Rm, lo, hi, tol, buf);
  for (long i = lo; i < hi; ++i) {
    out_re[i] = buf[i].real();
    out_im[i] = buf[i].imag();
  }
}

void am_eigvals_z(const cplx* R, long ld, long lo, long hi, double tol,
                  double* out_re, double* out_im) {
  M<cplx> Rm{const_cast<cplx*>(R), ld};
  cplx buf[512];
  copy_eigenvalues(Rm, lo, hi, tol, buf);
  for (long i = lo; i < hi; ++i) {
    out_re[i] = buf[i].real();
    out_im[i] = buf[i].imag();
  }
}

void am_residuals_d(const double* H, long ld, long m, const double* Q, long qld,
                    double h_last, long lo, long hi, double* rs) {
  M<double> Hm{const_cast<double*>(H), ld};
  M<double> Qm{const_cast<double*>(Q), qld};
  cplx xbuf[512];
  copy_residuals(Hm, m, Qm, h_last, lo, hi, rs, xbuf);
}

void am_residuals_z(const cplx* H, long ld, long m, const cplx* Q, long qld,
                    const cplx* h_last, long lo, long hi, double* rs) {
  M<cplx> Hm{const_cast<cplx*>(H), ld};
  M<cplx> Qm{const_cast<cplx*>(Q), qld};
  cplx xbuf[512];
  copy_residuals(Hm, m, Qm, *h_last, lo, hi, rs, xbuf);
}

}  // extern "C"
