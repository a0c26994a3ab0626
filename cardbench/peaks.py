"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W).  A run prints the card's power limit beside every share
read against them: a card set below 700 W runs slower under load."""

# HBM3 bandwidth, bytes a second.
BYTES_S = 3.35e12

# Lane-instructions a second outside the tensor cores, an FMA counted as
# one: the published 67 TFLOP/s (float32) and 34 TFLOP/s (float64) count
# an FMA as two operations.
LANE_OPS_S = {"float32": 67e12 / 2, "float64": 34e12 / 2}
