"""One reader per metric, found by the metric's name: `<name>.py` defines
`read(run) -> float | None`, where `run` is what the cell's loop measured
(`hcbench/loops.py`, `hcbench/run.py`).  A reader that finds nothing to
read returns None, and the metric is left out of the result line."""
