"""post_select_ms.graph: the traced slice's time per step less the
selection kernels' device time per step (`select_roofline.select_ms`): the
candidate merge, the relevance metrics, the expansion and the expanded-node
scoring, with the step's host syncs."""
from hcbench.metrics.select_roofline import select_ms


def read(run):
    ms = select_ms(run)
    if ms is None:
        return None
    t = run["trace"]
    return t["window_s"] * 1e3 / t["steps"] - ms
