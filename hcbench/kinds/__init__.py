"""One module per kind of cell, found by the name in a configuration's
`"kind"` key: `hcbench/kinds/<kind>.py`, loaded by its path (`spec.py`).
A kind is what a cell feeds the program, how it drives and judges it; a
configuration of another kind comes with its own module and no edit to the
harness.  The module defines:

  * `make_inputs(config, g, device) -> {name: tensor}`  the deployment's
    data drawn from the seed's generator `g` (the program and the reference
    get the same arrays);
  * `System(config, inputs, device)`  the program set up from them; the
    program is imported inside it, never at module level;
  * `LOOPS`  `{traffic["loop"]: class}`, each built as
    `(system, traffic, g, seed, device, int(config["dim"]))` with
    `warm_up()`, `window(seconds, tracer=None) -> run` (at least `steps`,
    `attempted`, `failed`, `window_s`), `kept_batches() -> [(inputs,
    outputs)]` and `close()`;
  * `Reference(config, inputs, device, precision=None)`  the plain
    reference, nothing of the program; `lowered(precision)` the precision
    one step below the stated one (the control's);
  * `judge(ref, traffic, batches) -> (numbers, info)`  the numbers held to
    the cell's limits, each the worst over the kept batches, and `info`
    with `answers`; `control_outputs(low, traffic, inputs)` what the
    lowered reference answers, in the program's layout;
  * `work_problem(traffic, config) -> str | None`  why the traffic's work
    could depend on the seed (the cell is then refused);
  * `trace_info(config, traffic) -> dict`  what the kind's readers need
    beside a traced slice, added to `run`;
  * `finish_info(info)`  the kind's last words on `info`, in place.

`run.py` runs one process on `cuda:0` after checking that the machine has
the cell's `chips` cards; a kind whose deployment spans cards states its
ranks in its configuration and starts them itself.
"""
