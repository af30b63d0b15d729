"""retrieval: batches of unit query vectors into
`QueryEngine.query_batch_device` (selection, relevance, k-hop expansion,
expanded-node scoring), judged by the top-k, relevance and expansion
numbers of `hcbench/check.py`.  Every object is the harness's own, bound
here by name."""

from hcbench import check, data, loops, reference, spec, system
from hcbench.bounds import select_bound_ms

make_inputs = data.make_corpus
System = system.System
LOOPS = loops.LOOPS
Reference = reference.Reference
lowered = reference.lowered
judge = check.judge
control_outputs = check.control_outputs
work_problem = spec.fixed_work_problem


def trace_info(config, traffic):
    """The selection's kernels (`select_kernels`) and its least time at the
    traffic's shapes (`select_bound_ms`), for `metrics/select_roofline.py`."""
    return {"select_kernels": config.get("select_kernels"),
            "select_bound_ms": select_bound_ms(
                int(traffic["batch"]), int(config["rows"]), int(config["dim"]),
                config["select_bank"], int(traffic["top_k"]))}


def finish_info(info):
    """The share of judged queries whose subgraph reached `max_expanded`,
    in place of its two sums."""
    if "queries" in info:
        info["full_subgraph_share"] = info.pop("full_subgraphs") / info.pop("queries")
