"""select_host_ms: host milliseconds per traced step inside `engine.select`
(the selection with its merge): query quantization, checks, the tile plan,
the kernels' launches."""
from hcbench.metrics._program import span_per_step


def read(run):
    return span_per_step(run, "engine.select", "host_ms")
