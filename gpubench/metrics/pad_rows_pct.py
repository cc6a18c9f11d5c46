"""Padded node rows' share of all node rows of the sampled batches that
the program laid out in set-up (its ``layout.*`` counters)."""

from gpubench.program import counters


def read(run):
    c = counters.read()
    if run.get("trace") is None or not c or not c["layout.node_rows"]:
        return None
    return 100.0 * (1.0 - c["layout.real_node_rows"] / c["layout.node_rows"])
