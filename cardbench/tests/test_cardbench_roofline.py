"""The roofline counts, pinned from shapes, and the bound a blocked kernel
cannot beat."""

import pytest

from cardbench import peaks
from cardbench.roofline import filtered_matvec, least_time, orthogonalization


def test_filtered_matvec_counts():
    # The north star's filter: 3200^2 float32, degree 1000.
    n = 3200 * 3200
    nbytes, ops = filtered_matvec.work(n, 1000, 4)
    assert nbytes == 2 * n * 4
    assert ops == n * (5 + 999 * 6)
    t, by = least_time(nbytes, ops, "float32")
    assert by == "operations"
    assert t == pytest.approx(ops / 33.5e12)
    assert filtered_matvec.work(7, 1, 8) == (2 * 7 * 8, 7 * 5)
    with pytest.raises(ValueError):
        filtered_matvec.work(7, 0, 4)


@pytest.mark.parametrize("steps_a_pass", [1, 2, 4, 8, 16, 50, 1000])
def test_a_blocked_filter_cannot_read_over_100(steps_a_pass):
    """A kernel doing s degree steps a pass reads x once and writes y once a
    pass, and issues at least the counted instructions (halos it
    recomputes only add to them): its own least time is never below the
    counted one, so its share stays at most 100 %."""
    n, degree, item = 3200 * 3200, 1000, 4
    bound, _ = least_time(*filtered_matvec.work(n, degree, item), "float32")
    passes = -(-degree // steps_a_pass)
    kernel_bytes = passes * 2 * n * item
    _, ops = filtered_matvec.work(n, degree, item)
    kernel_time = max(kernel_bytes / peaks.BYTES_S,
                      ops / peaks.LANE_OPS_S["float32"])
    assert bound <= kernel_time
    assert 100 * bound / kernel_time <= 100


def test_orthogonalization_counts():
    n = 1024 * 1024
    rows = orthogonalization.range_rows(0, 80)
    assert rows == list(range(1, 81)) and sum(rows) == 3240
    nbytes, ops = orthogonalization.work(n, rows, 4)
    assert nbytes == (3240 + 2 * 80) * n * 4
    assert ops == (2 * 3240 + 2 * 80) * n
    t, by = least_time(nbytes, ops, "float32")
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    assert orthogonalization.range_rows(40, 43) == [41, 42, 43]


def test_orthogonalization_does_not_count_passes():
    """Two Gram-Schmidt passes over one read of the rows cost no more
    counted bytes than one: DGKS or CGS2 in one kernel stays <= 100 %."""
    one = orthogonalization.step_work(1000, 50, 4)
    assert orthogonalization.work(1000, [50], 4) == one
