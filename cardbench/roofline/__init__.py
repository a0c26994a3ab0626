"""The least time a unit of work can take on the card, from its shapes.

Each file of this folder counts one unit of work: the bytes it has to move
(every input byte read once, every output byte written once) and the
FMA-counted lane-instructions it has to issue.  A share of the roofline is
that least time over the device time of the kernels that did the work, so
it does not depend on how many launches did it, and cannot pass 100 %
unless the counts are too high or the time misses part of the work."""

from cardbench import peaks


def least_time(nbytes, ops, dtype):
    """(seconds, bound_by): the larger of bytes over the memory rate and
    lane-instructions over the issue rate of `dtype` ("float32" or
    "float64"); bound_by is "bytes" or "operations"."""
    t_bytes = nbytes / peaks.BYTES_S
    t_ops = ops / peaks.LANE_OPS_S[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
