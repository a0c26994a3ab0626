"""interval_s: the benchmark's own span around estimate_interval, mean
over the window's solves."""


def read(record):
    spans = [s["spans"]["interval_s"] for s in record["solves"]
             if "interval_s" in s["spans"]]
    return sum(spans) / len(spans) if spans else None
