"""entry_self_ms: host milliseconds per traced step inside `engine.step`
(`query_batch_device`) outside its child spans: the per-call operands and
their pinned copies, the entity-word loop, the step's set-up."""
from hcbench.metrics._program import span_per_step


def read(run):
    return span_per_step(run, "engine.step", "self_ms")
