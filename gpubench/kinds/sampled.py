"""GraphSAGE minibatches: ``seeds`` seed nodes a step with ``fanout``, a
pool of ``pool`` samples drawn from the seed in set-up and replayed in
turn (the checked steps are the pool's first, so they all differ)."""

from __future__ import annotations

import torch

from gpubench import graphs


def inputs(cell: dict, seed: int, device) -> dict:
    conf, traffic = cell["config"], cell["traffic"]
    graph = conf["graph"]
    ptr, col = graphs.csr(graph, seed, device)
    in_deg = ptr[1:] - ptr[:-1]
    stats = {"max_in_degree": int(in_deg.max()),
             "min_in_degree": int(in_deg.min())}
    gen = graphs.generator(seed, 4, device)
    samples = [graphs.sample(ptr, col, traffic["seeds"],
                             tuple(traffic["fanout"]), gen)
               for _ in range(traffic["pool"])]
    del ptr, col, in_deg
    node = graphs.node_inputs(graph, seed, device,
                              d_out=conf["model"].get("d_out", 0))
    stats["sample_nodes"] = [int(s["node_ids"].numel()) for s in samples]
    stats["sample_edges"] = [int(s["senders"].numel()) for s in samples]
    return {"pool": samples, "inputs": node,
            "host": {k: v.cpu() for k, v in node.items()},
            "sizes": [(int(s["node_ids"].numel()), int(s["senders"].numel()))
                      for s in samples],
            "nodes_per_step": traffic["seeds"], "stats": stats}


def program_batches(cell: dict, data: dict, prog, prog_cell) -> list:
    node, host = data.pop("inputs"), data["host"]
    view = {"x": node["x"], "x_host": host["x"].numpy(),
            "positions_host": host["positions"].numpy(),
            "target_host": host["target"].numpy()}
    return [prog.sampled_batch(s, view, cell["traffic"], prog_cell)
            for s in data["pool"]]


def ref_batch(data: dict, i: int, device) -> dict:
    s, node = data["pool"][i], data["host"]
    ids = s["node_ids"].cpu()
    batch = {"x": node["x"][ids], "senders": s["senders"],
             "receivers": s["receivers"],
             "positions": node["positions"][ids], "target": node["target"]}
    if "labels" in node:
        batch["labels"] = node["labels"][ids]
    mask = torch.zeros(ids.numel())
    mask[:s["n_seeds"]] = 1.0
    batch["mask"] = mask
    return {k: (v.to(device) if torch.is_tensor(v) else v)
            for k, v in batch.items()}
