"""Full-batch training: the whole graph every step, every node in the
loss."""

from __future__ import annotations

import torch

from gpubench import graphs


def inputs(cell: dict, seed: int, device) -> dict:
    graph = cell["config"]["graph"]
    senders, receivers = graphs.edges(graph, seed, device)
    g = {**graphs.node_inputs(graph, seed, device), "senders": senders,
         "receivers": receivers}
    g["mask"] = torch.ones(graph["n_nodes"], device=device)
    n, e = graph["n_nodes"], senders.numel()
    return {"pool": [g], "sizes": [(n, e)], "nodes_per_step": n,
            "stats": {"max_in_degree": int(torch.bincount(
                          receivers, minlength=n).max()),
                      "max_out_degree": int(torch.bincount(
                          senders, minlength=n).max()),
                      "edges": e}}


def program_batches(cell: dict, data: dict, prog, prog_cell) -> list:
    return [prog.full_batch(g, prog_cell) for g in data["pool"]]


def ref_batch(data: dict, i: int, device) -> dict:
    return data["pool"][i]
