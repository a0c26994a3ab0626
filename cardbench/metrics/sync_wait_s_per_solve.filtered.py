"""sync_wait_s_per_solve.filtered: sync_wait_s_per_solve in the filtered
recipe's cells, where it moves filtered_solve_s."""

from cardbench.metrics.sync_wait_s_per_solve import read  # noqa: F401
