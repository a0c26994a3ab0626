"""expansion_self_ms_per_step: the expansion's host span less its waits
on the card, History.timings["device"] - timings["sync_wait"], summed over
the window's solves, per Krylov step (History.mvproducts), in ms: the
host's own work of enqueuing a step.  None where the program keeps no
sync_wait total."""


def read(record):
    solves = record["solves"]
    steps = sum(s["history"]["mvproducts"] for s in solves)
    own = 0.0
    for s in solves:
        t = s["history"]["timings"]
        if t.get("device") is None or t.get("sync_wait") is None:
            return None
        own += t["device"] - t["sync_wait"]
    if not steps:
        return None
    return 1e3 * own / steps
