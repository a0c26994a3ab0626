"""One application of a degree-d Chebyshev filter p(A) of a 5-point
stencil A to a vector of n elements: y = p(A) x.

Bytes: x read once and y written once.  The iterates between are the
filter's own business: a kernel that keeps them on chip (several degree
steps a pass) moves less than one that writes every step out, and the
least time is the same for both.

Operations, a point: a degree step y_{k+1} = p_k L(y_k) - q_k y_{k-1},
L(v) = (A v - c v) / e, needs the five stencil products (one multiply and
four FMAs, with p_k / e and the shift folded into the five coefficients)
and one FMA for -q_k y_{k-1}: 6.  The first step has no y_{k-1}: 5."""

STENCIL_OPS = 5
RECURRENCE_OPS = 1


def work(n, degree, itemsize):
    """(bytes, lane-instructions) of one filtered matvec."""
    if degree < 1:
        raise ValueError("degree must be at least 1")
    nbytes = 2 * n * itemsize
    ops = n * (STENCIL_OPS + (degree - 1) * (STENCIL_OPS + RECURRENCE_OPS))
    return nbytes, ops
