"""One reader a metric: metrics/<name>.py defines read(record), which
returns the metric's value or None where the record has nothing to read
(see harness.py for the record).  A metric split by the end-to-end metric
it moves (`<name>.filtered` in the filtered recipe's cells) takes its
reader from the unsplit one."""
