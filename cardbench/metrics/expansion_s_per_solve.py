"""expansion_s_per_solve: History.timings["device"], the host span around
the Krylov expansion and its H readback (waits included), mean over the
window's solves."""


def read(record):
    vals = [s["history"]["timings"].get("device") for s in record["solves"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
