"""One reader per per-layer metric, `<metric>.py`, found by the metric's
name; each has `read(readings) -> value or None` (None: nothing to read in
this run, and the metric is left out of the line)."""
