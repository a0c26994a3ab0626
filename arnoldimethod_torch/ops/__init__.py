from .expansion import (
    apply_basis_change,
    expand_range,
    set_initial_vector,
    set_random_vector,
)

__all__ = [
    "expand_range",
    "apply_basis_change",
    "set_initial_vector",
    "set_random_vector",
]
