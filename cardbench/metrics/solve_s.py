"""solve_s: the window, from the first solve's start to the last solve's
end, over the number of solves in it."""


def read(record):
    solves = record["solves"]
    return record["window_s"] / len(solves) if solves else None
