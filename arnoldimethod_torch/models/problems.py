"""Model problems: standard test/benchmark matrices as operators.

The same five builders as arnoldimethod_tpu/models/problems.py (1-D
Laplacian readme.md:30-34, tridiagonal, 2-D Laplacian and
convection-diffusion from BASELINE.json, the periodic convection-diffusion
torus), with the same coefficients.  Each returns the DIA layout by default
or, for the 2-D grids, the 5-point stencil with fmt="stencil"; every builder
takes the `device` its operator lives on, the card by default.  fmt="ell" gives the padded ELL
layout of the same matrix, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .operators import DiaOperator, EllOperator, Stencil5Operator, _numpy_dtype

__all__ = ["laplacian_1d", "tridiagonal", "laplacian_2d", "convection_diffusion_2d", "convection_diffusion_periodic_2d"]


def _ell_from_dia(offset_values, n, dtype, device):
    offsets = sorted(offset_values)
    data = np.zeros((n, len(offsets)), dtype=dtype)
    cols = np.zeros((n, len(offsets)), dtype=np.int32)
    i = np.arange(n)
    for d, off in enumerate(offsets):
        valid = (i + off >= 0) & (i + off < n)
        vals = np.broadcast_to(np.asarray(offset_values[off], dtype=dtype), (n,))
        data[valid, d] = vals[valid]
        cols[valid, d] = i[valid] + off
    return EllOperator(data, cols, (n, n), device=device)


def _build(offset_values, n, dtype, fmt, device):
    dtype = _numpy_dtype(dtype)
    if fmt == "ell":
        return _ell_from_dia(offset_values, n, dtype, device)
    if fmt != "dia":
        raise ValueError(f"unknown sparse format {fmt!r}")
    offsets = sorted(offset_values)
    diags = np.zeros((len(offsets), n), dtype=dtype)
    for d, off in enumerate(offsets):
        diags[d] = offset_values[off]
        if off > 0:
            diags[d, n - off :] = 0
        elif off < 0:
            diags[d, : -off] = 0
    return DiaOperator(diags, offsets, (n, n), device=device)


def tridiagonal(n, lower, diag, upper, dtype=torch.float64, fmt="dia",
                device=None):
    """Tridiagonal Toeplitz matrix."""
    return _build({-1: lower, 0: diag, 1: upper}, n, dtype, fmt, device)


def laplacian_1d(n, dtype=torch.float64, fmt="dia", device=None):
    """1-D Laplacian (-1, 2, -1): the README parity matrix
    (ref: readme.md:30-34)."""
    return tridiagonal(n, -1.0, 2.0, -1.0, dtype=dtype, fmt=fmt, device=device)


def _grid_2d(nx, ny, center, west, east, north, south, dtype, fmt, device):
    if fmt == "stencil":
        return Stencil5Operator((center, west, east, north, south), (ny, nx),
                                dtype=dtype, device=device)
    n = nx * ny
    i = np.arange(n)
    in_row_left = i % nx != 0  # has a west neighbor
    in_row_right = i % nx != nx - 1  # has an east neighbor
    offset_values = {
        -nx: np.full(n, north),
        -1: np.where(in_row_left, west, 0.0),
        0: np.full(n, center),
        1: np.where(in_row_right, east, 0.0),
        nx: np.full(n, south),
    }
    return _build(offset_values, n, dtype, fmt, device)


def laplacian_2d(nx, ny=None, dtype=torch.float64, fmt="dia", device=None):
    """2-D 5-point Laplacian on an nx-by-ny grid (row-major ordering),
    n = nx*ny rows with <= 5 nonzeros per row."""
    if ny is None:
        ny = nx
    return _grid_2d(nx, ny, 4.0, -1.0, -1.0, -1.0, -1.0, dtype, fmt, device)


def convection_diffusion_2d(nx, ny=None, peclet=10.0, dtype=torch.float64,
                            fmt="dia", device=None):
    """Nonsymmetric 2-D convection-diffusion (central-difference convection
    in x): produces complex conjugate eigenvalue pairs for the 2x2-block
    real Schur path (BASELINE.json config 3)."""
    if ny is None:
        ny = nx
    h = 1.0 / (nx + 1)
    beta = peclet * h / 2.0
    return _grid_2d(nx, ny, 4.0, -1.0 - beta, -1.0 + beta, -1.0, -1.0, dtype,
                    fmt, device)


def convection_diffusion_periodic_2d(nx, ny=None, cx=0.15, cy=0.08,
                                     scale=1.0, dtype=torch.float32,
                                     device=None):
    """Periodic (torus) convection-diffusion: the 2-D circulant stencil

        scale * [ 4, -1-cx, -1+cx, -1-cy, -1+cy ]  (c, w, e, n, s)

    nonsymmetric yet normal, with the exact spectrum

        lam(j, k) = scale * [ (2 - 2 cos th_j) + (2 - 2 cos ph_k)
                              + 2 i (cx sin th_j + cy sin ph_k) ]

    th_j = 2 pi j / nx, ph_k = 2 pi k / ny (see the JAX package's builder
    for why it is the checkable nonsymmetric model problem)."""
    if ny is None:
        ny = nx
    c = [4.0, -1.0 - cx, -1.0 + cx, -1.0 - cy, -1.0 + cy]
    return Stencil5Operator(
        tuple(scale * v for v in c), (ny, nx), dtype=dtype,
        boundary="periodic", device=device,
    )
