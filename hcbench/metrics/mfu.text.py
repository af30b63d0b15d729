"""mfu.text: the query encoder's model FLOPs per step (`model_flops_per_step`
from the text kind's `trace_info`: the real tokens' projections,
feed-forward and attention products, padding not counted) over the traced
slice's seconds per step times float32's peak outside the tensor cores
(`hcbench/bounds.py`; the encoder refuses TF32), in percent."""
from hcbench.bounds import PEAK_OPS


def read(run):
    t, flops = run.get("trace"), run.get("model_flops_per_step")
    if not t or not t.get("steps") or not flops or t["window_s"] <= 0:
        return None
    return 100.0 * flops * t["steps"] / (t["window_s"] * PEAK_OPS["f32"])
