"""device_idle_share.filtered: device_idle_share in the filtered recipe's cells, where it
moves filtered_solve_s."""

from cardbench.metrics.device_idle_share import read  # noqa: F401
