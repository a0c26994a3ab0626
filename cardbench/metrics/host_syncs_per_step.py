"""host_syncs_per_step: History.host_syncs over History.mvproducts, summed
over the window's solves: the device-to-host reads a Krylov step waits
for."""


def read(record):
    steps = sum(s["history"]["mvproducts"] for s in record["solves"])
    if not steps:
        return None
    return sum(s["history"]["host_syncs"] for s in record["solves"]) / steps
