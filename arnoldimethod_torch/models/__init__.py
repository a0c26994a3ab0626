from .operators import (
    DenseOperator,
    DiaOperator,
    FunctionOperator,
    LinearOperator,
    Stencil5Operator,
    as_operator,
)
from .problems import (
    convection_diffusion_2d,
    convection_diffusion_periodic_2d,
    laplacian_1d,
    laplacian_2d,
    tridiagonal,
)

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "DiaOperator",
    "FunctionOperator",
    "Stencil5Operator",
    "as_operator",
    "laplacian_1d",
    "laplacian_2d",
    "tridiagonal",
    "convection_diffusion_2d",
    "convection_diffusion_periodic_2d",
]
