"""launches_per_step.filtered: launches_per_step in the filtered recipe's cells, where it
moves filtered_solve_s."""

from cardbench.metrics.launches_per_step import read  # noqa: F401
