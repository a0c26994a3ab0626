"""dense_schur_s_per_solve: History.timings["dense_schur"], the host
seconds of each restart's Francis QR, Ritz values and residual estimates
(a part of dense_s_per_solve), mean over the window's solves.  None where
the program keeps no such total."""


def read(record):
    vals = [s["history"]["timings"].get("dense_schur")
            for s in record["solves"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
