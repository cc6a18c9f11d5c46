"""Host seconds a batch of the program's layout of sampled batches
(``steps.subgraph_batch``), in set-up (its ``layout.*`` counters)."""

from gpubench.program import counters


def read(run):
    c = counters.read()
    if run.get("trace") is None or not c or not c["layout.batches"]:
        return None
    return c["layout.host_ns"] / 1e9 / c["layout.batches"]
