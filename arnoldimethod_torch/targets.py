"""Eigenvalue targets and orderings.

A `Target` selects which part of the spectrum `partial_schur` hunts for;
`get_order(which)` turns it into a sort key over complex eigenvalues such
that *smaller key = more wanted*.  Python's stable sorts give exactly the
reference's `OrderPerm` tie-breaking (stable permutation sort, so conjugate
pairs stay adjacent).

Behavioral reference: ArnoldiMethod.jl src/targets.jl (the LM/LR/SR/LI/SI
types and get_order at :71-75).
"""

from __future__ import annotations

__all__ = ["Target", "LM", "LR", "SR", "LI", "SI", "get_order", "as_target"]


class Target:
    """Base class for eigenvalue targets."""

    def __repr__(self):
        return f"{type(self).__name__}()"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class LM(Target):
    """Largest magnitude: |lambda| largest first."""


class LR(Target):
    """Largest real part first."""


class SR(Target):
    """Smallest real part first."""


class LI(Target):
    """Largest imaginary part first (only meaningful in complex arithmetic)."""


class SI(Target):
    """Smallest imaginary part first (only meaningful in complex arithmetic)."""


_SYMBOLS = {
    "LM": LM,
    "LR": LR,
    "SR": SR,
    "LI": LI,
    "SI": SI,
}


def as_target(which):
    """Accept a Target instance or a string name ('LM', 'SR', ...)
    (ref: run.jl:181-185)."""
    if isinstance(which, Target):
        return which
    if isinstance(which, str):
        key = which.upper().lstrip(":")
        if key in _SYMBOLS:
            return _SYMBOLS[key]()
    raise ValueError(f"Unknown target: {which!r}")


def get_order(which):
    """Sort key: more-wanted eigenvalues have smaller keys
    (ref: targets.jl:71-75)."""
    which = as_target(which)
    if isinstance(which, LM):
        return lambda lam: -abs(lam)
    if isinstance(which, LR):
        return lambda lam: -lam.real
    if isinstance(which, SR):
        return lambda lam: lam.real
    if isinstance(which, LI):
        return lambda lam: -lam.imag
    if isinstance(which, SI):
        return lambda lam: lam.imag
    raise ValueError(f"Unknown target: {which!r}")
