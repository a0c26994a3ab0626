"""One Krylov step's orthogonalization: a new vector w of n elements made
orthogonal to the j + 1 basis rows V[0..j] and normalized.

Bytes: each of the j + 1 rows read once, w read once and written once.
A second Gram-Schmidt pass (DGKS, CGS2) reads the rows again; the least
time does not count it, so a kernel that projects twice from one read of
the rows is not refused as impossible.

Operations: one classical Gram-Schmidt pass, h = V w and w -= V^T h, is
2 (j + 1) n FMAs; the norm and the scaling 2 n more."""


def step_work(n, rows, itemsize):
    """(bytes, lane-instructions) of one step projecting against `rows`
    basis rows."""
    nbytes = (rows + 2) * n * itemsize
    ops = (2 * rows + 2) * n
    return nbytes, ops


def range_rows(j0, j1):
    """The rows each step of a Krylov range from basis size j0 to j1
    projects against: the step that makes row j + 1 projects against rows
    0..j, j + 1 of them."""
    return [j + 1 for j in range(j0, j1)]


def work(n, rows, itemsize):
    """(bytes, lane-instructions) of the steps whose row counts are
    `rows` (a list, one entry a step)."""
    nbytes = ops = 0
    for r in rows:
        b, o = step_work(n, r, itemsize)
        nbytes += b
        ops += o
    return nbytes, ops
