"""expansion_self_ms_per_step.filtered: expansion_self_ms_per_step in the
filtered recipe's cells, where it moves filtered_solve_s."""

from cardbench.metrics.expansion_self_ms_per_step import read  # noqa: F401
