"""select_roofline.text: select_roofline in a text cell."""
from hcbench.metrics.select_roofline import read  # noqa: F401
