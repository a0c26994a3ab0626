"""device_idle_share: the share of the traced slice's main part in which
no operation ran on the device, in %."""


def read(record):
    part = (record.get("slice") or {}).get("steps")
    if part is None or part["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - part["busy_s"] / part["wall_s"])
