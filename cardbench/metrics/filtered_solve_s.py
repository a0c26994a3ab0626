"""filtered_solve_s: solve_s of the filtered recipe's cells (interval,
filter, solve and Rayleigh-Ritz, each solve), a metric of its own so that
its bound is set from those cells' spread."""

from cardbench.metrics.solve_s import read  # noqa: F401
