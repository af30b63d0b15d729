"""device_idle_pct: the share of the traced slice in which no operation ran
on the device (the union of the profiler's device intervals), in percent."""


def read(run):
    t = run.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
