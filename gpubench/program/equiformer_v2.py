"""EquiformerV2's sampled batches in the program's layout: the sample as
the program's ``SampledSubgraph``, padded to the program's
``sampled_subgraph_sizes``, laid out by ``steps.subgraph_batch`` (which
gathers the rows and works out each edge's Wigner blocks on the host)."""

from __future__ import annotations

import numpy as np


def sampled_batch(sample: dict, inputs: dict, traffic: dict, cell):
    from repro_torch.data.sampler import SampledSubgraph
    from repro_torch.launch import steps

    n_pad, e_pad = steps.sampled_subgraph_sizes(traffic["seeds"],
                                                tuple(traffic["fanout"]))
    ids = sample["node_ids"].cpu().numpy()
    snd = sample["senders"].cpu().numpy()
    rcv = sample["receivers"].cpu().numpy()
    n, e = ids.size, snd.size

    def padded(a, size, dtype):
        out = np.zeros(size, dtype)
        out[:a.size] = a
        return out

    sub = SampledSubgraph(
        node_ids=padded(ids, n_pad, np.int32),
        senders=padded(snd, e_pad, np.int32),
        receivers=padded(rcv, e_pad, np.int32),
        node_mask=padded(np.ones(n, np.float32), n_pad, np.float32),
        edge_mask=padded(np.ones(e, np.float32), e_pad, np.float32),
        seed_mask=padded(np.ones(sample["n_seeds"], np.float32), n_pad,
                         np.float32),
        n_real_nodes=n, n_real_edges=e)
    batch = steps.subgraph_batch(cell.arch, cell.cfg, sub, inputs["x_host"],
                                 inputs["target_host"],
                                 positions=inputs["positions_host"])
    return batch.to(inputs["x"].device)
