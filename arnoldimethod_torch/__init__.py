"""arnoldimethod_torch: the PyTorch/CUDA port of arnoldimethod_tpu.

Computes partial Schur decompositions A Q = Q R and partial
eigendecompositions of large square matrices and matrix-free operators for
eigenvalues nearest a target (LM/LR/SR/LI/SI), via the restarted Arnoldi
method with Krylov-Schur restarts.  The n-sized work runs on the operator's
torch device (a CUDA card or the CPU); the small dense restart runs on the
host in float64.  The JAX package beside it is the reference the port is
held against; module paths and public names match it.

    partial_schur(A, nev=..., which=..., tol=...)  -> (PartialSchur, History)
    partial_eigen(decomp)                          -> (values, vectors)
    ArnoldiWorkspace                               -- resume/warm-start state
    LM, LR, SR, LI, SI                             -- eigenvalue targets
    parallel                                       -- row-sharded solves
                                                      over torch.distributed
"""

from .driver import History, PartialSchur, partial_schur
from .eigen import partial_eigen
from .targets import LI, LM, LR, SI, SR, Target
from .transforms import (
    BInnerProductOperator,
    ChebyshevFilterOperator,
    CirculantShiftInvertOperator,
    GeneralizedShiftInvertOperator,
    estimate_interval,
    power_bound,
    rayleigh_ritz,
)
from .workspace import ArnoldiWorkspace
from . import parallel
from .models.operators import (
    CsrOperator,
    DenseOperator,
    DiaOperator,
    EllOperator,
    FunctionOperator,
    LinearOperator,
    SellOperator,
    ShardedCsrOperator,
    ShiftInvertDenseOperator,
    SplitComplexDenseOperator,
    SplitComplexOperator,
    Stencil5Operator,
    TridiagonalShiftInvertOperator,
    as_operator,
    csr_to_ell,
    dia_from_diagonals,
)

__version__ = "0.1.0"

__all__ = [
    "partial_schur",
    "partial_eigen",
    "ArnoldiWorkspace",
    "PartialSchur",
    "History",
    "Target",
    "LM",
    "LR",
    "SR",
    "LI",
    "SI",
    "LinearOperator",
    "DenseOperator",
    "DiaOperator",
    "dia_from_diagonals",
    "EllOperator",
    "CsrOperator",
    "SellOperator",
    "ShardedCsrOperator",
    "Stencil5Operator",
    "SplitComplexOperator",
    "SplitComplexDenseOperator",
    "FunctionOperator",
    "ShiftInvertDenseOperator",
    "TridiagonalShiftInvertOperator",
    "GeneralizedShiftInvertOperator",
    "BInnerProductOperator",
    "ChebyshevFilterOperator",
    "CirculantShiftInvertOperator",
    "estimate_interval",
    "power_bound",
    "rayleigh_ritz",
    "as_operator",
    "csr_to_ell",
    "parallel",
]
