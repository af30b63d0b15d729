"""select_roofline: the selection's least time from its shapes
(`hcbench/bounds.py`) over its device time per step in the traced slice of
the window, in percent.  The selection's device time is that of the
kernels the configuration's `select_kernels` names (a name matches when it
holds one of them), over the steps issued inside the slice."""


def select_ms(run):
    """Device milliseconds of the selection kernels per traced step, or None."""
    t, names = run.get("trace"), run.get("select_kernels")
    if not t or not t.get("steps") or not names:
        return None
    s = sum(v for op, v in t["op_s"].items() if any(k in op for k in names))
    return s * 1e3 / t["steps"] if s > 0 else None


def read(run):
    ms, bound = select_ms(run), run.get("select_bound_ms")
    if ms is None or bound is None:
        return None
    return 100.0 * bound / ms
