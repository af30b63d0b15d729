"""device_idle_pct.graph: device_idle_pct in the graph cell."""
from hcbench.metrics.device_idle_pct import read  # noqa: F401
