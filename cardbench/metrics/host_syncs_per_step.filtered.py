"""host_syncs_per_step.filtered: host_syncs_per_step in the filtered recipe's cells, where it
moves filtered_solve_s."""

from cardbench.metrics.host_syncs_per_step import read  # noqa: F401
