"""One reader per metric, found by the metric's name: `read(run)` returns
the value, or None where the run holds nothing to read (the harness then
leaves the metric out of the line)."""
