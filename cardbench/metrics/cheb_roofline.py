"""cheb_roofline: the Chebyshev filter's least time on the card over the
device time of every kernel in the traced slice of filtered matvecs, in
%.  The work is counted from shapes, a filtered matvec at a time
(cardbench/roofline/filtered_matvec.py), whatever the number of launches
that did it."""

from cardbench.roofline import filtered_matvec, least_time


def read(record):
    part = (record.get("slice") or {}).get("steps")
    if part is None or "filtered_matvec" not in part["work"]:
        return None
    w = part["work"]["filtered_matvec"]
    seconds = sum(b - a for _, a, b in part["ops"]) / 1e6
    if seconds <= 0:
        return None
    nbytes, ops = filtered_matvec.work(w["n"], w["degree"], w["itemsize"])
    bound, _ = least_time(nbytes * w["count"], ops * w["count"],
                          record["dtype"])
    return 100.0 * bound / seconds
