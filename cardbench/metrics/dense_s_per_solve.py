"""dense_s_per_solve: History.timings["dense"], the host span of the host
dense restart, mean over the window's solves."""


def read(record):
    vals = [s["history"]["timings"].get("dense") for s in record["solves"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
