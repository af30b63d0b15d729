"""graph_qps: qps of subgraph queries (the same reading, its own metric)."""
from hcbench.metrics.qps import read  # noqa: F401
