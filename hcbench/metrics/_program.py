"""What the program's recorder (`hcrag_tpu_torch.utils.timing`: `summary()`)
holds of a traced slice: the spans and counters recorded while the slice's
profiler ran, the only time a run records.  Every reading is per step, over
the `engine.step` spans recorded.  A run without a trace, a program without
the recorder, or a slice with no step recorded reads None."""


def recorded(run):
    """The recorder's summary of the traced slice, or None."""
    if not run.get("trace"):
        return None
    try:
        from hcrag_tpu_torch.utils import timing
    except ImportError:
        return None
    summary = getattr(timing, "summary", None)
    if summary is None:
        return None
    out = summary()
    return out if out.get("steps") else None


def span_per_step(run, name, field):
    """`field` (`host_ms` or `self_ms`) of the spans `name`,
    summed over the slice, per step; None where no such span was recorded."""
    s = recorded(run)
    if s is None:
        return None
    v = s["spans"].get(name, {}).get(field)
    return None if v is None else v / s["steps"]


def counter(run, name):
    """The counter `name` over the slice and the steps it spans, or None."""
    s = recorded(run)
    if s is None or name not in s["counters"]:
        return None
    return s["counters"][name], s["steps"]
