"""tokenize_ms.text: host milliseconds per traced step inside
`engine.tokenize` (the WordPiece tokenization of the batch and the pinned
copies of its ids and mask)."""
from hcbench.metrics._program import span_per_step


def read(run):
    return span_per_step(run, "engine.tokenize", "host_ms")
