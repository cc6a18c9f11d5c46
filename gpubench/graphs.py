"""The traffic generators: graphs, node inputs and neighbour samples, made
on the device from the seed.

A graph's edges come from the law its configuration names (``graph["law"]``,
a module of :mod:`gpubench.laws` found by that name, which draws pairs of
nodes).  An undirected graph (``graph["symmetric"]``) is stored both ways,
as GNN trainers take it: ``n_edges`` counts the directed edges, so the law
draws half as many pairs and each is added in both directions.  A graph
that asks for them gets one self-loop a node after its message edges.

Sampling is GraphSAGE's: a seed batch drawn without replacement, then for
each hop every frontier entry (repeats included) draws min(fanout, degree)
distinct in-neighbours (Floyd's algorithm), and the picks are the next
frontier.  A sample keeps its own nodes (the seeds first, then the others
by id) and edges, with no padding.
"""

from __future__ import annotations

import importlib

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one input stream of ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def edges(graph: dict, seed: int, device) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(senders, receivers), int64: ``n_edges`` message edges of the
    graph's law in the order drawn (each pair, then each pair reversed,
    when ``graph["symmetric"]``), then a self-loop a node when
    ``graph["self_loops"]``."""
    law = importlib.import_module(f"gpubench.laws.{graph['law']}")
    n, e = graph["n_nodes"], graph["n_edges"]
    symmetric = graph.get("symmetric", False)
    if symmetric and e % 2:
        raise ValueError(f"a symmetric graph has an even n_edges, not {e}")
    senders, receivers = law.pairs(graph, e // 2 if symmetric else e,
                                   generator(seed, 1, device))
    if symmetric:
        senders, receivers = (torch.cat([senders, receivers]),
                              torch.cat([receivers, senders]))
    if graph.get("self_loops"):
        loops = torch.arange(n, device=device)
        senders = torch.cat([senders, loops])
        receivers = torch.cat([receivers, loops])
    return senders, receivers


def csr(graph: dict, seed: int, device) -> tuple[torch.Tensor,
                                                 torch.Tensor]:
    """The in-neighbour CSR (``ptr`` (V + 1,), ``col`` (E,)) of the
    message edges of :func:`edges`: node v's in-neighbours are
    ``col[ptr[v]:ptr[v + 1]]``."""
    senders, receivers = edges({**graph, "self_loops": False}, seed, device)
    order = torch.argsort(receivers)
    col = senders[order]
    counts = torch.bincount(receivers, minlength=graph["n_nodes"])
    ptr = torch.zeros(graph["n_nodes"] + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=ptr[1:])
    return ptr, col


def node_inputs(graph: dict, seed: int, device, *, d_out: int = 0) -> dict:
    """Seeded node features ``x`` (V, d_feat) f32; class ``labels`` (V,)
    when the graph has classes; ``positions`` (V, 3) f64 and a graph
    ``target`` (1, d_out) f32 when ``d_out``."""
    gen = generator(seed, 2, device)
    n = graph["n_nodes"]
    out = {"x": torch.randn(n, graph["d_feat"], generator=gen,
                            device=device)}
    if graph.get("n_classes"):
        out["labels"] = torch.randint(0, graph["n_classes"], (n,),
                                      generator=gen, device=device)
    if d_out:
        out["positions"] = torch.randn(n, 3, dtype=torch.float64,
                                       generator=gen, device=device)
        out["target"] = torch.randn(1, d_out, generator=gen, device=device)
    return out


def sample(ptr: torch.Tensor, col: torch.Tensor, n_seeds: int,
           fanout: tuple, gen: torch.Generator) -> dict:
    """One GraphSAGE sample: ``node_ids`` (global, the seeds first),
    ``senders`` and ``receivers`` (local ids, the hops in order) and
    ``n_seeds``."""
    n = ptr.numel() - 1
    dev = ptr.device
    seeds = torch.randperm(n, generator=gen, device=dev)[:n_seeds]
    frontier, snd, rcv = seeds, [], []
    for f in fanout:
        lo = ptr[frontier]
        deg = ptr[frontier + 1] - lo
        take = deg.clamp(max=f)
        chosen = torch.full((frontier.numel(), f), -1, dtype=torch.int64,
                            device=dev)
        for i in range(f):
            j = deg - take + i
            t = torch.floor(torch.rand(frontier.numel(), dtype=torch.float64,
                                       generator=gen, device=dev)
                            * (j + 1).to(torch.float64)).long()
            t = torch.minimum(t, j)
            seen = (chosen == t[:, None]).any(dim=1)
            chosen[:, i] = torch.where(i < take, torch.where(seen, j, t), -1)
        keep = chosen >= 0
        picks = col[(lo[:, None] + chosen)[keep]]
        snd.append(picks)
        rcv.append(frontier[:, None].expand_as(chosen)[keep])
        frontier = picks
    snd, rcv = torch.cat(snd), torch.cat(rcv)
    loc = torch.full((n,), -1, dtype=torch.int64, device=dev)
    loc[seeds] = torch.arange(n_seeds, device=dev)
    others = torch.unique(snd)
    others = others[loc[others] < 0]
    loc[others] = n_seeds + torch.arange(others.numel(), device=dev)
    return {"node_ids": torch.cat([seeds, others]), "senders": loc[snd],
            "receivers": loc[rcv], "n_seeds": n_seeds}
