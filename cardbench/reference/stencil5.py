"""Plain reference of the constant-coefficient 5-point Dirichlet stencil:
its matvec in float64, its exact spectrum and eigenvectors in closed form,
and the control, the same closed form computed in TF32."""

import math

import numpy as np
import torch

from cardbench.reference import round_tf32


def _symmetric(spec):
    c, w, e, no, so = (float(v) for v in spec["coeffs"])
    if spec["boundary"] != "dirichlet" or w != e or no != so:
        raise ValueError("the closed form needs a Dirichlet stencil with "
                         "west = east and north = south")
    return c, w, no


def norm_bound(spec):
    """sum |coefficients|, a bound on ||A||_2 and the scale the numbers
    are measured in."""
    return float(sum(abs(float(v)) for v in spec["coeffs"]))


def matvec_rows(X, spec):
    """A x for every row x of X (rows of length ny * nx, row-major grid),
    computed in X's dtype: a zero halo and five shifted reads."""
    c, w, e, no, so = (float(v) for v in spec["coeffs"])
    ny, nx = spec["grid"]
    g = X.reshape(-1, ny, nx)
    gp = torch.nn.functional.pad(g, (1, 1, 1, 1))
    y = (c * g + w * gp[:, 1:-1, :-2] + e * gp[:, 1:-1, 2:]
         + no * gp[:, :-2, 1:-1] + so * gp[:, 2:, 1:-1])
    return y.reshape(X.shape)


def _axis(c_axis, n):
    """The eigenvalues 2 c_axis cos(j pi / (n + 1)), j = 1..n, in float64."""
    j = np.arange(1, n + 1)
    return 2.0 * c_axis * np.cos(j * np.pi / (n + 1))


def smallest(spec, k):
    """The k smallest eigenvalues of A, ascending, in float64."""
    c, w, no = _symmetric(spec)
    ny, nx = spec["grid"]
    lx = np.sort(_axis(w, nx))[:k]
    ly = np.sort(_axis(no, ny))[:k]
    return np.sort((c + np.add.outer(ly, lx)).ravel())[:k]


def control(spec, k, seed, device):
    """The reference put in the program's place at one precision below the
    configuration's float32: the k smallest eigenpairs from the closed
    form with every operation rounded to TF32 (10 mantissa bits), the basis
    rotated by a random orthogonal k x k matrix drawn from `seed`.
    Returns (Q_rows (k, n) float32, R (k, k) float64 numpy, values (k,)
    float64 numpy), the rotation's R = Omega^T diag(values) Omega."""
    c, w, no = _symmetric(spec)
    ny, nx = spec["grid"]
    t = round_tf32
    f32 = dict(dtype=torch.float32, device=device)

    def axis(c_axis, n):
        ang = t(t(torch.arange(1, n + 1, **f32) * t(torch.tensor(math.pi, **f32)))
                / t(torch.tensor(float(n + 1), **f32)))
        lam = t(t(torch.tensor(2.0 * c_axis, **f32)) * t(torch.cos(ang)))
        return ang, lam

    angx, lx = axis(w, nx)
    angy, ly = axis(no, ny)
    lam = t(t(torch.tensor(c, **f32) + ly[:, None]) + lx[None, :]).ravel()
    order = torch.argsort(lam, stable=True)[:k].cpu().numpy()
    kk, jj = np.divmod(order, nx)
    values = lam[torch.as_tensor(order, device=device)]

    gx = t(torch.arange(1, nx + 1, **f32))
    gy = t(torch.arange(1, ny + 1, **f32))
    sx = t(torch.sqrt(t(torch.tensor(2.0 / (nx + 1), **f32))))
    sy = t(torch.sqrt(t(torch.tensor(2.0 / (ny + 1), **f32))))
    V = torch.empty((k, ny * nx), **f32)
    for r in range(k):
        ux = t(t(torch.sin(t(angx[jj[r]] * gx))) * sx)
        uy = t(t(torch.sin(t(angy[kk[r]] * gy))) * sy)
        V[r] = t(uy[:, None] * ux[None, :]).ravel()

    rng = np.random.default_rng(seed)
    omega, _ = np.linalg.qr(rng.standard_normal((k, k)))
    om = t(torch.as_tensor(omega, **f32))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # TF32 operands, float32 sums: each product of two TF32 values is
        # exact in float32, as on the tensor cores.
        Q = t(om.T @ V)
        R = t(t(om.T * values[None, :]) @ om)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    del V
    return (Q, R.double().cpu().numpy(),
            values.double().cpu().numpy())
