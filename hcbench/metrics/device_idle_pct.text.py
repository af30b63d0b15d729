"""device_idle_pct.text: device_idle_pct in a text cell."""
from hcbench.metrics.device_idle_pct import read  # noqa: F401
