"""host_syncs.graph: host syncs per traced step (the `engine.expand.sync`
spans: the early exit's reads of the device); 0 where steps were recorded
with none."""
from hcbench.metrics._program import recorded


def read(run):
    s = recorded(run)
    return None if s is None else s["spans"].get("engine.expand.sync", {}).get("n", 0) / s["steps"]
