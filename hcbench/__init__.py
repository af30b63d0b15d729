"""hcbench — the benchmark of `hcrag_tpu_torch` on NVIDIA GPUs.

    python3 -m hcbench.run --workload kg1m_int8.batch8k --seed 7 --seconds 20 --trace 0

`BENCHMARK.json` at the repository's root lists the cells; each cell is a
configuration (`configs/`) under a traffic mix (`traffic/`), judged by
the limits in `limits/<cell>.json` and reported by the readers in
`metrics/` (`spec.py`).  A configuration names its kind, a module in
`kinds/` that says what a run feeds, drives and judges.  A run of the
`retrieval` kind (`kinds/retrieval.py`) draws its data from the seed on
the card (`data.py`), builds the program from it (`system.py`), drives
the traffic (`loops.py`), traces a slice of the window when asked
(`trace.py`), and judges the answers against the plain reference
(`reference.py`, `check.py`).  `bounds.py` holds the frozen roofline
arithmetic.
`control.py`, never run by the benchmark itself, takes the readings that
the limits are set from.  The JAX package is never imported.
"""
