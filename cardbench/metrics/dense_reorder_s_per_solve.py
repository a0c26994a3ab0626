"""dense_reorder_s_per_solve: History.timings["dense_reorder"], the host
seconds of each restart's three-way partition and Hessenberg restore and
of the final sort (a part of dense_s_per_solve), mean over the window's
solves.  None where the program keeps no such total."""


def read(record):
    vals = [s["history"]["timings"].get("dense_reorder")
            for s in record["solves"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
