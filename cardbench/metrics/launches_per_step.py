"""launches_per_step: device kernels (copies and fills not counted) in the
traced slice's main part over its Krylov steps (filtered matvecs where
the slice is of the filter alone)."""


def read(record):
    part = (record.get("slice") or {}).get("steps")
    if part is None or not part["steps"]:
        return None
    return part["kernels"] / part["steps"]
