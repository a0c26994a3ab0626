"""setup_s: seconds from the start of the process to the opening of the
window: imports, the program's builds (nvcc and g++ at a checkout's first
run), the operator and the warm-up."""


def read(record):
    return record["setup_s"]
