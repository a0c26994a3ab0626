"""peak_mem_GiB: the most device memory the program held during a solve
of the window (torch.cuda.max_memory_allocated, the benchmark's kept
answers subtracted), in GiB."""


def read(record):
    return record["peak_bytes"] / 2**30
