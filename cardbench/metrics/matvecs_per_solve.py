"""matvecs_per_solve: History.mvproducts (the operator's applications;
filtered matvecs in a filtered recipe), mean over the window's solves."""


def read(record):
    solves = record["solves"]
    if not solves:
        return None
    return sum(s["history"]["mvproducts"] for s in solves) / len(solves)
