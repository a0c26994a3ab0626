"""restart_kernel_ms: mean device time of a launch of the dense restart
kernel (a name holding "restart_kernel") in the traced slice's short
solve."""

FRAGMENT = "restart_kernel"


def read(record):
    part = (record.get("slice") or {}).get("steps")
    if part is None:
        return None
    times = [b - a for name, a, b in part["ops"] if FRAGMENT in name]
    return sum(times) / len(times) / 1e3 if times else None
