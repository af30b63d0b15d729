"""qps: the queries of every step issued in the window over the time until
the last of them completed (host clock)."""


def read(run):
    if "completed_queries" not in run:
        return None
    return run["completed_queries"] / run["window_s"]
