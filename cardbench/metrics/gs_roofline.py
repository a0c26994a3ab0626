"""gs_roofline: the orthogonalization's least time on the card over the
device time of the kernels that did it, in %, over the traced slice's
first Krylov range.  The work is counted from shapes, a step at a time
(cardbench/roofline/orthogonalization.py); the kernels are the cuBLAS
GEMVs ("gemv" in the name)."""

from cardbench.roofline import least_time, orthogonalization

FRAGMENT = "gemv"


def read(record):
    part = (record.get("slice") or {}).get("range")
    if part is None or "orthogonalization" not in part["work"]:
        return None
    w = part["work"]["orthogonalization"]
    seconds = sum(b - a for name, a, b in part["ops"]
                  if FRAGMENT in name) / 1e6
    if seconds <= 0:
        return None
    rows = orthogonalization.range_rows(w["j0"], w["j1"])
    nbytes, ops = orthogonalization.work(w["n"], rows, w["itemsize"])
    bound, _ = least_time(nbytes, ops, record["dtype"])
    return 100.0 * bound / seconds
