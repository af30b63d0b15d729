"""select_roofline.graph: select_roofline in a subgraph cell."""
from hcbench.metrics.select_roofline import read  # noqa: F401
