"""issue_ms: the median host time from a call of `query_batch_device` to
its return, over the window's steps; at depth 1 the step has no host sync,
so this is the time to issue it."""
import numpy as np


def read(run):
    issue = run.get("issue_s")
    if not issue:
        return None
    return float(np.median(issue)) * 1e3
