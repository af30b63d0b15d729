"""pad_share.text: the share of the encoded tokens that are padding,
100 x (1 - `encode.tokens` / `encode.padded_tokens`), from the program's
counters over the traced slice."""
from hcbench.metrics._program import counter


def read(run):
    real, padded = counter(run, "encode.tokens"), counter(run, "encode.padded_tokens")
    if real is None or padded is None or not padded[0]:
        return None
    return 100.0 * (1.0 - real[0] / padded[0])
