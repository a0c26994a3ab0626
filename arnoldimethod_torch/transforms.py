"""Spectral transformations: the reference's documented user-side recipes
(docs/src/index.md:230-352) as operators, and the Chebyshev filter that
makes the smallest eigenvalues of a large operator a cheap :LM problem.

  * shift-and-invert for the generalized problem A x = B x lambda
    (GeneralizedShiftInvertOperator, docs recipe :262-304);
  * B-inner-product Schur decomposition for s.p.d. B via Cholesky
    (BInnerProductOperator, docs recipe :306-352);
  * the Chebyshev polynomial filter (ChebyshevFilterOperator) with its
    interval bootstrap (`power_bound`, `estimate_interval`) and the
    Rayleigh-Ritz back-map to the operator's own spectrum
    (`rayleigh_ritz`);
  * FFT shift-invert for periodic stencils (CirculantShiftInvertOperator).

The dense and tridiagonal shift-invert operators live in models.operators.
Matmuls outside `partial_schur` run in full FP32 here (TF32 off inside each
function), as the JAX package asks `Precision.HIGHEST`.

Behavioral reference: arnoldimethod_tpu/transforms.py.  Where the port
differs on purpose: the filter over a real Dirichlet stencil takes the
fused step kernel (`ops.stencil.stencil5_cheb_step`) where the JAX package
pins the stencil to XLA; the circulant's inverse symbol is one complex
tensor; `rayleigh_ritz` forms complex Ritz vectors of a real basis on the
device; random draws come from a `torch.Generator`; BInnerProductOperator
applies the docs recipe's L^{-1} A L^{-H} (see its docstring).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from . import trace
from .models.operators import (
    FunctionOperator,
    LinearOperator,
    Stencil5Operator,
    _float_matrix,
    _promote_with_shift,
    _solve_rhs,
    _tensor,
    as_operator,
)
from .ops import stencil
from .ops.expansion import (
    expand_range,
    fp32_matmul,
    orthonormalize_rows,
    set_initial_vector,
)

__all__ = [
    "GeneralizedShiftInvertOperator",
    "BInnerProductOperator",
    "ChebyshevFilterOperator",
    "CirculantShiftInvertOperator",
    "Interval",
    "estimate_interval",
    "power_bound",
    "rayleigh_ritz",
]

Interval = collections.namedtuple("Interval", ["a", "b", "lo"])


def _real_numpy_dtype(dtype):
    """The numpy real dtype of a torch dtype (float32 for complex64)."""
    return np.float32 if dtype in (torch.float32, torch.complex64) else np.float64


class GeneralizedShiftInvertOperator(LinearOperator):
    """x -> (A - sigma B)^{-1} B x for the generalized problem
    A x = B x lambda: eigenvalues transform as theta = 1/(lambda - sigma),
    so target which='LM' and map back with `eigenvalues_back`
    (ref: docs/src/index.md:262-304).  `lu`, `piv` are
    `torch.linalg.lu_factor`'s (1-based pivots)."""

    def __init__(self, lu, piv, B, sigma, shape):
        self.lu = lu
        self.piv = piv
        self.B = B
        self.sigma = sigma
        self.shape = tuple(shape)
        self.dtype = lu.dtype
        self.device = lu.device

    @classmethod
    def build(cls, A, B, sigma=0.0, device=None):
        A = _float_matrix(A, device)
        B = _float_matrix(B, A.device)
        # A Python sigma is weak: a float32 pencil with sigma=0.5 stays
        # float32; numpy and torch scalars keep their dtype.
        dtype = _promote_with_shift(torch.promote_types(A.dtype, B.dtype),
                                    sigma)
        B = B.to(dtype)
        with fp32_matmul():
            lu, piv = torch.linalg.lu_factor(A.to(dtype) - sigma * B)
        return cls(lu, piv, B, sigma, A.shape)

    def matvec(self, x):
        with fp32_matmul():
            return _solve_rhs(
                lambda rhs: torch.linalg.lu_solve(self.lu, self.piv,
                                                  self.B @ rhs), x)

    def eigenvalues_back(self, thetas):
        """Map the transformed eigenvalues theta back to lambda."""
        return self.sigma + 1.0 / thetas


class BInnerProductOperator(LinearOperator):
    """C = L^{-1} A L^{-H} where B = L L^H (Cholesky): a standard Schur
    decomposition C Y = Y R yields a B-orthonormal partial Schur
    decomposition of the pencil — Q = L^{-H} Y satisfies Q^H A Q = R and
    Q^H B Q = I (ref: docs/src/index.md:306-352).

    The JAX package applies L^{-H} A L^{-1}, which agrees with this for a
    diagonal B (the docs' example) and breaks Q^H A Q = R for any other
    s.p.d. B; the port applies the recipe's order."""

    def __init__(self, A, L, shape):
        self.A = A
        self.L = L
        self.shape = tuple(shape)
        self.dtype = A.dtype
        self.device = A.device

    @classmethod
    def build(cls, A, B, device=None):
        A = _float_matrix(A, device)
        B = _float_matrix(B, A.device)
        dtype = torch.promote_types(A.dtype, B.dtype)
        with fp32_matmul():
            L = torch.linalg.cholesky(B.to(dtype))
        return cls(A.to(dtype), L, A.shape)

    def matvec(self, x):
        def solve(t):
            t = torch.linalg.solve_triangular(self.L.mH, t, upper=True)
            t = self.A @ t
            return torch.linalg.solve_triangular(self.L, t, upper=False)

        with fp32_matmul():
            return _solve_rhs(solve, x)

    def recover_q(self, Y):
        """Map Schur vectors Y of C back to B-orthonormal vectors Q of the
        original pencil: Q = L^{-H} Y."""
        with fp32_matmul():
            return _solve_rhs(
                lambda t: torch.linalg.solve_triangular(self.L.mH, t,
                                                        upper=True),
                Y.to(self.dtype))


class ChebyshevFilterOperator(LinearOperator):
    """Chebyshev polynomial filter p(A) = T_k((A - c I)/e), c = (a+b)/2,
    e = (b-a)/2: eigenvalues inside the damping interval [a, b] map into
    [-1, 1], eigenvalues below `a` are amplified like cosh(k*acosh|.|),
    exponentially in the degree.  Solving p(A) with which='LM' therefore
    targets A's smallest eigenvalues with restart counts that shrink by
    about the filter's amplification, at `degree` A-matvecs per operator
    application.  The filtered operator shares A's invariant subspaces:
    recover A's eigenvalues from the converged Schur vectors with
    `rayleigh_ritz`.

    scale_point: a point at (or slightly above) the spectrum's lower edge.
    When given, the scaled three-term recurrence
    y_{k+1} = 2 sigma_{k+1} L y_k - sigma_k sigma_{k+1} y_{k-1}
    (Zhou & Saad's Chebyshev-Davidson normalization) divides every iterate
    by T_k(t(scale_point)), so |p| stays about <= 1 across the spectrum and
    float32 cannot overflow at high degree.  None = unscaled T_k.

    Each degree step is y_{k+1} = p_k L(y_k) - q_k y_{k-1} with
    L(v) = (A v - c v) * (1/e); the (p_k, q_k) are computed once, on the
    host, in the operator's real dtype, exactly as the JAX package carries
    sigma in its loop (p = 2 sigma', q = sigma sigma').  Over a real
    Dirichlet Stencil5Operator (unless it has use_pallas=False) a step is
    one launch of the fused stencil kernel on the card
    (`ops.stencil.stencil5_cheb_step`; its plain version on the CPU), and
    the recurrence ping-pongs between two buffers; any other operator
    takes its own matvec plus torch ops.  The operator keeps the inner op
    as given (a periodic stencil stays periodic).
    """

    def __init__(self, op, a, b, degree, scale_point=None):
        self.op = as_operator(op)
        self.a = float(a)
        self.b = float(b)
        self.degree = int(degree)
        if self.degree < 1:
            raise ValueError("ChebyshevFilterOperator degree must be >= 1")
        self.scale_point = None if scale_point is None else float(scale_point)
        self.shape = self.op.shape
        self.dtype = self.op.dtype
        self.device = self.op.device
        self.first, self.steps = self._coefficients()

    def _coefficients(self):
        """(p_0, [(p_k, q_k) for k = 1 .. degree-1]) as Python floats
        holding values of the operator's real dtype."""
        real = _real_numpy_dtype(self.dtype)
        n_steps = self.degree - 1
        if self.scale_point is None:
            return 1.0, [(2.0, 1.0)] * n_steps
        c = (self.a + self.b) / 2
        e = (self.b - self.a) / 2
        t0v = (self.scale_point - c) / e
        sig = real(1.0 / t0v)
        two_t0 = real(2.0 * t0v)
        first = float(sig)
        steps = []
        for _ in range(n_steps):
            sig_next = real(1.0) / (two_t0 - sig)
            steps.append((float(real(2.0) * sig_next), float(sig * sig_next)))
            sig = sig_next
        return first, steps

    def matvec(self, x):
        c = (self.a + self.b) / 2
        inv_e = 1.0 / ((self.b - self.a) / 2)
        if isinstance(self.op, Stencil5Operator) and self.op._takes_kernel(x):
            kw = dict(coeffs=self.op.coeffs, grid=self.op.grid, c=c,
                      inv_e=inv_e)

            def step(y, z, p, q, out):
                return stencil.stencil5_cheb_step(y, z, p=p, q=q, out=out,
                                                  **kw)
        else:
            def step(y, z, p, q, out):
                lv = (self.op.matvec(y) - c * y) * inv_e
                return p * lv if z is None else p * lv - q * z

        y_prev, y = x, step(x, None, self.first, 0.0, None)
        for p, q in self.steps:
            # y_{k+1} overwrites y_{k-1}'s buffer, except the caller's x.
            out = None if y_prev is x else y_prev
            y_prev, y = y, step(y, y_prev, p, q, out)
        return y


class CirculantShiftInvertOperator(LinearOperator):
    """x -> (A - sigma I)^{-1} x for a PERIODIC constant-coefficient
    stencil (a 2-D circulant), solved exactly by FFT diagonalization:
    ifft2( fft2(x) / (symbol - sigma) ).  Each application is two
    n log n FFTs (`torch.fft`) and one elementwise product.  The inverse
    symbol is computed on the host in complex128 and held as one complex
    tensor (complex64 for a float32 stencil; the JAX package holds it as
    two real words).

    Eigenvalues transform as theta = 1/(lambda - sigma): target which='LM'
    and map back with `eigenvalues_back`.  Nonsymmetric stencils
    (convection) give complex conjugate theta pairs, with cluster gaps
    magnified by 1/|lambda - sigma|^2."""

    def __init__(self, inv, grid, sigma, dtype):
        self.inv = inv
        self.grid = tuple(grid)
        self.sigma = float(sigma)
        n = self.grid[0] * self.grid[1]
        self.shape = (n, n)
        self.dtype = dtype
        self.device = inv.device

    @classmethod
    def build(cls, op, sigma):
        """From a periodic Stencil5Operator and a real shift (sigma must
        not equal any eigenvalue), on the stencil's device."""
        if not (isinstance(op, Stencil5Operator)
                and op.boundary == "periodic"):
            raise ValueError(
                "CirculantShiftInvertOperator needs a periodic "
                "Stencil5Operator"
            )
        if op._complex_coeffs:
            # The matvec returns the real part of the inverse FFT, exact
            # only for a conjugate-symmetric (real-coefficient) symbol.
            raise NotImplementedError(
                "CirculantShiftInvertOperator supports real-coefficient "
                "periodic stencils only (complex coefficients would need "
                "a complex-output inverse)"
            )
        ny, nx = op.grid
        c, w, e, no, so = [complex(v) for v in op.coeffs]
        th = 2.0 * np.pi * np.arange(nx) / nx
        ph = 2.0 * np.pi * np.arange(ny) / ny
        sym = (
            c
            + w * np.exp(-1j * th)[None, :]
            + e * np.exp(1j * th)[None, :]
            + no * np.exp(-1j * ph)[:, None]
            + so * np.exp(1j * ph)[:, None]
        )
        inv = 1.0 / (sym - sigma)
        word = (torch.float32 if op.dtype in (torch.float32, torch.complex64)
                else torch.float64)
        cdtype = torch.complex64 if word == torch.float32 else torch.complex128
        return cls(_tensor(inv, op.device, cdtype), op.grid, sigma, word)

    def matvec(self, x):
        ny, nx = self.grid
        X = torch.fft.fft2(x.reshape(ny, nx))
        y = torch.fft.ifft2(X * self.inv).real
        return y.to(self.dtype).reshape(ny * nx)

    def eigenvalues_back(self, thetas):
        """theta = 1/(lambda - sigma)  =>  lambda = sigma + 1/theta."""
        return self.sigma + 1.0 / thetas


def power_bound(A, iters=20, seed=0, safety=1.05):
    """Upper bound on the spectral radius by `iters` power iterations with
    a safety factor: the `b` endpoint for ChebyshevFilterOperator.  The
    start vector is drawn from a torch.Generator seeded with `seed`."""
    op = as_operator(A)
    gen = torch.Generator(device=op.device).manual_seed(seed)
    v = torch.randn(op.shape[0], dtype=op.dtype, device=op.device,
                    generator=gen)
    nrm = 1.0  # the norm is real, also for complex operators
    with fp32_matmul(), trace.span("power_bound"):
        for _ in range(iters):
            w = op.matvec(v)
            nrm = torch.linalg.vector_norm(w)
            v = w / nrm
        return float(nrm) * safety


def _mv_rows(op, X):
    """op.matvec of every row of X (c, n) into a new (c, n) tensor; each
    row is made contiguous first (a columns-layout slice is strided)."""
    out = torch.empty(X.shape, dtype=X.dtype, device=X.device)
    for i in range(X.shape[0]):
        out[i] = op.matvec(X[i].contiguous())
    return out


def estimate_interval(A, nev, maxdim=None, safety=3.0, seed=0, b_iters=30,
                      refine=2, refine_degree=100, which="SR"):
    """Damping interval for ChebyshevFilterOperator computed from solver
    outputs only, no knowledge of the spectrum required.  Returns an
    `Interval(a, b, lo)` where (a, b) is the interval to DAMP and `lo` is
    the scale point at the wanted edge: pass them straight to
    `ChebyshevFilterOperator(op, iv.a, iv.b, deg, scale_point=iv.lo)`.

    which="SR" (default, the smallest-eigenvalue recipe): b is
    `power_bound`'s upper bound on the spectral radius; lo estimates the
    spectrum's lower edge; a sits `safety` x the estimated width of the
    wanted band above lo.

    which="LM" (the mirrored recipe for the largest-real-part end of a
    spectrum in a thin ellipse around the real axis): the damped interval
    is [lo_edge, a_cut], lo_edge underestimating the lower edge (a power
    bound on b I - A), a_cut `safety` band-widths below the top; the
    returned `lo` is the polished top edge (the scale point).

    The first (lo, a) guess comes from one coarse m-step Arnoldi pass
    (m ~ 2*nev + 10, at most 160, or `maxdim`); then `refine` rounds of
    Chebyshev-filtered subspace iteration on a random (nev+5)-row block
    (filter, orthonormalize, Rayleigh-Ritz on A) re-tighten the edges.
    `refine_degree` is one degree for every round or a per-round
    sequence (then `refine` is ignored).  Cost: b_iters + m +
    (nev+5)*sum(degrees) matvecs.  `which` is checked before any device
    work; the coarse basis is freed before the block is allocated; the
    random draws come from a torch.Generator seeded with `seed` (so the
    interval differs slightly from the JAX package's)."""
    if which not in ("SR", "LM"):
        # Validate before the power bound and the coarse Arnoldi pass: at
        # 1M+ rows those are seconds of device work.
        raise ValueError("which must be 'SR' or 'LM'")
    op = as_operator(A)
    n = op.shape[0]
    with fp32_matmul(), trace.span("interval"):
        b = power_bound(op, iters=b_iters, seed=seed)
        m = int(maxdim or min(max(2 * nev + 10, 30), 160, n))
        with trace.span("interval_arnoldi"):
            gen = torch.Generator(device=op.device).manual_seed(seed)
            V = torch.zeros((m + 1, n), dtype=op.dtype, device=op.device)
            H = torch.zeros((m + 1, m), dtype=op.dtype, device=op.device)
            set_initial_vector(V, torch.randn(n, dtype=op.dtype,
                                              device=op.device,
                                              generator=gen))
            expand_range(op, V, H, 0, m, gen)
            # The JAX package reads H as float64 (a complex H drops its
            # imaginary part there too).
            Hs = H[:m, :m].real.to(torch.float64).cpu().numpy()
            # At nev=100 scale the coarse basis is ~5 GB: free it now.
            del V, H
            _, _, w0 = _schur_of_hessenberg(Hs)
        ritz = np.sort(w0.real)
        if which == "LM":
            return _estimate_interval_lm(op, nev, ritz, b, safety, seed,
                                         b_iters, refine, refine_degree, gen,
                                         m)
        return _estimate_interval_sr(op, nev, ritz, b, safety, refine,
                                     refine_degree, gen, m)


def _estimate_interval_sr(op, nev, ritz, b, safety, refine, refine_degree,
                          gen, m):
    n = op.shape[0]
    lo, theta = ritz[0], ritz[min(nev, m) - 1]

    def edge(lo, theta):
        a = lo + safety * (theta - lo)
        if not a < b:  # degenerate (flat) estimate: damp the top half
            a = lo + 0.5 * (b - lo)
        return a

    a = edge(lo, theta)
    k = min(nev + 5, n)
    X = torch.randn((k, n), dtype=op.dtype, device=op.device, generator=gen)
    for deg_r in _degree_schedule(refine, refine_degree):
        with trace.span("refine"):
            fop = ChebyshevFilterOperator(op, a, b, deg_r, scale_point=lo)
            Y = _mv_rows(fop, X)
            del X
            Q = orthonormalize_rows(Y, gen)
            w, _, _ = rayleigh_ritz(op, Q, rows_layout=True,
                                    return_vectors=False,
                                    compute_residuals=False)
            w = np.sort(np.asarray(w).real)
            lo, theta = min(lo, w[0]), w[min(nev, k) - 1]
            a = edge(lo, theta)
            X = Q
    return Interval(float(a), float(b), float(lo))


def _degree_schedule(refine, refine_degree):
    """refine_degree: one degree for every round, or a per-round schedule
    (a ramp like (100, 200, 400, 400) spends little while the interval is
    still coarse, and the full degree once the edges are near their
    targets; then `refine` is ignored)."""
    if np.isscalar(refine_degree):
        return [int(refine_degree)] * refine
    return [int(d) for d in refine_degree]


def _estimate_interval_lm(op, nev, ritz, b, safety, seed, b_iters, refine,
                          refine_degree, gen, m):
    """The mirrored (largest-end) interval recipe: damp [lo_edge, a_cut],
    scale at the polished top edge.  See estimate_interval(which="LM") and
    the JAX package's `_estimate_interval_lm` for the reasoning behind
    each clamp."""
    n = op.shape[0]
    # Lower spectrum edge, UNDERestimated through a power bound on b I - A.
    sop = FunctionOperator(lambda x: b * x - op.matvec(x), n, op.dtype,
                           device=op.device)
    lo_edge = b - power_bound(sop, iters=b_iters, seed=seed + 1)

    # Bootstrap hi clamped to the un-inflated power estimate b/1.05; each
    # refinement REPLACES hi with the projected Rayleigh estimate.
    hi, theta = min(ritz[-1], b / 1.05), ritz[-min(nev, m)]

    def edge(hi, theta):
        a = hi - safety * (hi - theta)
        if not a > lo_edge:  # degenerate flat estimate: damp the lower half
            a = hi - 0.5 * (hi - lo_edge)
        # keep a nonempty wanted zone strictly below the scale point
        return min(a, b - 0.02 * (b - lo_edge))

    a_cut = edge(hi, theta)
    k = min(nev + 5, n)
    X = torch.randn((k, n), dtype=op.dtype, device=op.device, generator=gen)
    for deg_r in _degree_schedule(refine, refine_degree):
        with trace.span("refine"):
            fop = ChebyshevFilterOperator(op, lo_edge, a_cut, deg_r,
                                          scale_point=hi)
            Y = _mv_rows(fop, X)
            del X
            Q = orthonormalize_rows(Y, gen)
            w, _, _ = rayleigh_ritz(op, Q, rows_layout=True,
                                    return_vectors=False,
                                    compute_residuals=False)
            wre = np.sort(np.asarray(w).real)
            hi, theta = min(wre[-1], b), wre[-min(nev, k)]
            # Monotone cut: a previous round's cut was already feasible.
            a_cut = max(edge(hi, theta), a_cut)
            X = Q

    # Polish the top edge by filtered power iteration (8 x degree 400);
    # the Rayleigh quotient plus its residual bound the edge from above.
    v = X[0]
    fpol = ChebyshevFilterOperator(op, lo_edge, a_cut, 400, scale_point=hi)
    for _ in range(8):
        v = fpol.matvec(v.contiguous())
        v = v / torch.linalg.vector_norm(v)
    Av = op.matvec(v)
    mu = float(torch.vdot(v, Av).real)
    r = float(torch.linalg.vector_norm(Av - mu * v))
    hi = mu + r + 4.0 * abs(mu) * float(torch.finfo(op.dtype.to_real()).eps)
    a_cut = max(edge(hi, theta), a_cut)
    return Interval(float(lo_edge), float(a_cut), float(hi))


def _schur_of_hessenberg(Hs):
    """In-house Schur factorization of a square host matrix already in
    upper-Hessenberg form: Francis QR (dense/schur.py, C++ fast path when
    built).  Returns (R, Q, eigenvalues); Hs is not modified."""
    from .dense import eigenvalues, local_schur
    from .dense import native as _native

    m = Hs.shape[0]
    R = np.array(Hs)
    Q = np.eye(m, dtype=R.dtype)
    if m > 1:
        if (_native.available() and m + 1 <= _native.MAX_DIM
                and not np.iscomplexobj(R)):
            _native.local_schur(R, 0, m, Q)
        else:
            local_schur(R, 0, m, Q)
    return R, Q, eigenvalues(R)


def _hessenberg_host(A):
    """Householder similarity reduction to upper-Hessenberg form (the
    pre-pass LAPACK's dgehrd does): returns (H, U) with U^H A U = H."""
    A = np.array(A)
    nd = A.shape[0]
    U = np.eye(nd, dtype=A.dtype)
    for j in range(nd - 2):
        x = A[j + 1:, j]
        nx = np.linalg.norm(x)
        if nx == 0:
            continue
        v = x.astype(A.dtype).copy()
        a0 = v[0]
        if np.iscomplexobj(A):
            phase = a0 / abs(a0) if a0 != 0 else 1.0
        else:
            phase = 1.0 if a0 >= 0 else -1.0
        v[0] += phase * nx
        vn = np.linalg.norm(v)
        if vn == 0:
            continue
        v /= vn
        A[j + 1:, j:] -= 2.0 * np.outer(v, v.conj() @ A[j + 1:, j:])
        A[:, j + 1:] -= 2.0 * np.outer(A[:, j + 1:] @ v, v.conj())
        U[:, j + 1:] -= 2.0 * np.outer(U[:, j + 1:] @ v, v.conj())
        A[j + 2:, j] = 0.0
    return A, U


def _dense_eig_host(S):
    """np.linalg.eig replacement for the small Rayleigh quotient:
    in-house Hessenberg reduction + Francis QR + quasi-triangular
    eigenvectors (dense/eig.py), exactly the partial_eigen machinery."""
    from .dense import collect_eigen

    nd = S.shape[0]
    if nd == 0:
        return np.zeros(0), np.zeros((0, 0))
    Hs, U = _hessenberg_host(S)
    R, Q, w = _schur_of_hessenberg(Hs)
    X = np.zeros((nd, nd), dtype=complex)
    buf = np.zeros(nd, dtype=complex)
    for j in range(nd):
        buf[:] = 0
        klen = collect_eigen(buf, R, j)
        col = np.zeros(nd, dtype=complex)
        col[:klen] = buf[:klen]
        if not np.iscomplexobj(R) and j > 0 and R[j, j - 1] != 0:
            col = np.conj(col)  # second member of a conjugate pair
        X[:, j] = col
    V = (U @ Q) @ X
    nrm = np.linalg.norm(V, axis=0)
    nrm[nrm == 0] = 1.0
    return w, V / nrm


def _row_norms(R):
    return torch.sqrt(torch.sum(torch.abs(R) ** 2, dim=1))


def rayleigh_ritz(A, Q, chunk=16, return_vectors=True, rows_layout=False,
                  compute_residuals=True):
    """Eigenvalues of A restricted to the (filtered-solve) basis Q: solve
    the small dense eigenproblem of Q^H A Q and return (values, vectors,
    residual_norms) with vectors = Q @ S rotated into A's eigenbasis.
    Used to map a ChebyshevFilterOperator solve back to A's spectrum.

    Memory-lean: A Q is never materialized (S and the residuals accumulate
    over `chunk`-row slices), and with `return_vectors=False` nothing
    basis-sized is allocated.  `rows_layout=True` takes Q as (k, n) rows
    (the solver's layout, `PartialSchur.Q_rows`); otherwise (n, k)
    columns, read through a transposed view, never copied whole.  The small
    eigenproblem uses the in-house dense kernels, not LAPACK.

    Values are a numpy array (real when every Ritz value is real),
    residuals a float64 numpy array.  Vectors are a tensor on Q's device in
    Q's layout: of Q's dtype, or complex when a real basis has complex Ritz
    pairs (the JAX package returns those as a host array)."""
    op = as_operator(A)
    Qr = Q if rows_layout else Q.T  # (k, n) view in both layouts
    k = Qr.shape[0]
    dtype = Q.dtype
    is_cplx = dtype.is_complex

    with fp32_matmul(), trace.span("rayleigh_ritz"):
        S = np.zeros((k, k), dtype=complex if is_cplx else np.float64)
        for c0 in range(0, k, chunk):
            AQc = _mv_rows(op, Qr[c0:c0 + chunk])
            S[:, c0:c0 + chunk] = (Qr.conj() @ AQc.T).cpu().numpy()

        w, Vs = _dense_eig_host(S)
        order = np.argsort(w.real)
        w, Vs = w[order], Vs[:, order]
        real_w = bool(np.all(np.abs(w.imag) < 1e-10 * (1 + np.abs(w.real))))
        if real_w:
            w = w.real

        if not compute_residuals and not return_vectors:
            # Eigenvalue-only mode (the ChebFSI bootstrap's inner loop):
            # skip the second chunked pass, which costs as much as the
            # projection pass.
            return w, None, None

        res = np.zeros(k) if compute_residuals else None
        chunks = [] if return_vectors else None
        dev = Q.device
        if real_w or is_cplx:
            Vdev = torch.as_tensor(Vs.real if real_w and not is_cplx else Vs)
            Vdev = Vdev.to(dtype=dtype, device=dev)
            wdev = torch.as_tensor(w).to(dtype=dtype, device=dev)
            for c0 in range(0, k, chunk):
                Xc = Vdev[:, c0:c0 + chunk].T @ Qr  # (c, n)
                if compute_residuals:
                    Rc = _mv_rows(op, Xc) - wdev[c0:c0 + chunk, None] * Xc
                    res[c0:c0 + chunk] = _row_norms(Rc).double().cpu().numpy()
                if return_vectors:
                    chunks.append(Xc)
        else:
            # Real basis, complex Ritz pairs: the complex Ritz vectors are
            # formed on the device from two real products; A acts on their
            # real and imaginary parts (A is real), and the residual is
            # taken in complex128, as the JAX package takes it on the host.
            Vr = torch.as_tensor(Vs.real).to(dtype=dtype, device=dev)
            Vi = torch.as_tensor(Vs.imag).to(dtype=dtype, device=dev)
            w128 = torch.as_tensor(w, dtype=torch.complex128, device=dev)
            for c0 in range(0, k, chunk):
                Xr = Vr[:, c0:c0 + chunk].T @ Qr
                Xi = Vi[:, c0:c0 + chunk].T @ Qr
                Xc = torch.complex(Xr, Xi)
                if compute_residuals:
                    AXc = torch.complex(_mv_rows(op, Xr), _mv_rows(op, Xi))
                    Rc = (AXc.to(torch.complex128)
                          - w128[c0:c0 + chunk, None]
                          * Xc.to(torch.complex128))
                    res[c0:c0 + chunk] = _row_norms(Rc).cpu().numpy()
                if return_vectors:
                    chunks.append(Xc)
        X = None
        if return_vectors:
            X = torch.cat(chunks, dim=0)
            X = X if rows_layout else X.T
    return w, X, res
