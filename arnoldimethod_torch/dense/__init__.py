"""Replicated small-dense layer: LAPACK-free host kernels on the
(maxdim+1) x maxdim Hessenberg workspace.  See the submodules for the
Francis QR, Sylvester-based Schur reordering, Hessenberg restoration and
quasi-triangular eigen solvers."""

from .rotations import givens, lmul2, lmul3, rmul2, rmul3, rot2_matrix, rot3_matrix
from .schur import (
    double_shift_qr,
    is_offdiagonal_small,
    local_schur,
    single_shift_qr,
    upper_triangular_2x2,
    use_single_shift,
)
from .sylvester import solve_complete_pivot, sylv
from .swaps import (
    is_end_of_11_block,
    is_start_of_11_block,
    rotate_left,
    rotate_right,
    swap,
    swap11,
    swap12,
    swap21,
    swap22,
)
from .restore import reflector, restore_arnoldi
from .eig import (
    collect_eigen,
    copy_eigenvalues,
    eigenvalue,
    eigenvalues,
    shifted_backward_sub,
)

__all__ = [
    "givens",
    "lmul2",
    "lmul3",
    "rmul2",
    "rmul3",
    "rot2_matrix",
    "rot3_matrix",
    "is_offdiagonal_small",
    "upper_triangular_2x2",
    "use_single_shift",
    "single_shift_qr",
    "double_shift_qr",
    "local_schur",
    "solve_complete_pivot",
    "sylv",
    "is_start_of_11_block",
    "is_end_of_11_block",
    "swap",
    "swap11",
    "swap12",
    "swap21",
    "swap22",
    "rotate_right",
    "rotate_left",
    "reflector",
    "restore_arnoldi",
    "collect_eigen",
    "copy_eigenvalues",
    "eigenvalue",
    "eigenvalues",
    "shifted_backward_sub",
]
