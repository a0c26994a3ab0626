"""sync_wait_s_per_solve: History.timings["sync_wait"], the host seconds
of every device-to-host read inside the expansion's span (a part of
expansion_s_per_solve), mean over the window's solves.  None where the
program keeps no such total."""


def read(record):
    vals = [s["history"]["timings"].get("sync_wait")
            for s in record["solves"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
