"""expand_yield.graph: the nodes the expansion kept (`expand.kept_nodes`,
the final counts' sum) over the candidate slots its dedups took
(`expand.candidate_slots`, batch x width of every dedup), in percent."""
from hcbench.metrics._program import counter


def read(run):
    kept, slots = counter(run, "expand.kept_nodes"), counter(run, "expand.candidate_slots")
    if kept is None or slots is None or not slots[0]:
        return None
    return 100.0 * kept[0] / slots[0]
