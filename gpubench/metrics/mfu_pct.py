"""The model FLOPs of the traced window's steps (the reference's formula
on each step's real nodes and edges, 3x the forward, no recompute) over
its seconds, as a share of the chips' dense peak in the step's dtype."""

from gpubench import peaks


def read(run):
    if run.get("trace") is None:
        return None
    peak = run["chips"] * peaks.FLOPS[run["dtype"]]
    return 100.0 * run["flops_per_step"] * run["steps"] / run[
        "window_s"] / peak
