"""The traffic generators: repeatable by seed, and the graph and samples
they promise, at small sizes on the CPU."""

import math

import torch

from gpubench import graphs

GRAPH = {"n_nodes": 20_000, "n_edges": 500_000, "d_feat": 4,
         "n_classes": 3, "law": "power_law", "degree_exponent": 3.0}
BIG_SEED = 2 ** 31 + 12345


def test_edges_repeat_by_seed_and_differ_across_seeds():
    a = graphs.edges(GRAPH, BIG_SEED, "cpu")
    b = graphs.edges(GRAPH, BIG_SEED, "cpu")
    c = graphs.edges(GRAPH, BIG_SEED + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    x = graphs.node_inputs(GRAPH, BIG_SEED, "cpu", d_out=1)
    y = graphs.node_inputs(GRAPH, BIG_SEED, "cpu", d_out=1)
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert set(x) == {"x", "labels", "positions", "target"}


def test_degree_statistics_follow_the_stated_law():
    snd, rcv = graphs.edges(GRAPH, 7, "cpu")
    n, e = GRAPH["n_nodes"], GRAPH["n_edges"]
    assert snd.numel() == e and not torch.any(snd == rcv)
    deg_in = torch.bincount(rcv, minlength=n).double()
    deg_out = torch.bincount(snd, minlength=n).double()
    assert deg_in.mean().item() == e / n
    # Rank weights r^-1/(gamma-1): the largest node's share of the edges.
    alpha = 1.0 / (GRAPH["degree_exponent"] - 1.0)
    w = torch.arange(1, n + 1, dtype=torch.float64) ** -alpha
    expect_max = e * (w[0] / w.sum()).item()
    for deg in (deg_in, deg_out):
        assert 0.8 * expect_max < deg.max().item() < 1.2 * expect_max
    # In- and out-degree are drawn apart: the two hubs are other nodes.
    assert deg_in.argmax() != deg_out.argmax()
    # The tail: P(k >= K) ~ K^-(gamma - 1), so the count of nodes above
    # 4x the mean over those above 2x the mean is about 2^-(gamma-1).
    mean = e / n
    ratio = ((deg_in >= 4 * mean).sum() / (deg_in >= 2 * mean).sum()).item()
    assert abs(math.log2(ratio) + (GRAPH["degree_exponent"] - 1)) < 0.5


def test_self_loops_are_appended_once_a_node():
    snd, rcv = graphs.edges({**GRAPH, "self_loops": True}, 3, "cpu")
    n, e = GRAPH["n_nodes"], GRAPH["n_edges"]
    assert snd.numel() == e + n
    assert torch.equal(snd[e:], torch.arange(n))
    assert torch.equal(rcv[e:], torch.arange(n))


def test_a_symmetric_graph_holds_each_pair_both_ways():
    graph = {**GRAPH, "symmetric": True, "self_loops": True}
    snd, rcv = graphs.edges(graph, BIG_SEED, "cpu")
    n, e = GRAPH["n_nodes"], GRAPH["n_edges"]
    assert snd.numel() == e + n and not torch.any(snd[:e] == rcv[:e])
    half = e // 2
    assert torch.equal(snd[:half], rcv[half:e])
    assert torch.equal(rcv[:half], snd[half:e])
    # The pairs are the law's own: drawn alike, from the same stream.
    one_way = graphs.edges({**GRAPH, "n_edges": half}, BIG_SEED, "cpu")
    assert torch.equal(one_way[0], snd[:half])
    assert torch.equal(one_way[1], rcv[:half])
    assert torch.equal(torch.bincount(snd, minlength=n),
                       torch.bincount(rcv, minlength=n))
    assert torch.bincount(rcv, minlength=n).double().mean().item() == (
        e + n) / n


def test_csr_holds_the_same_edges():
    snd, rcv = graphs.edges(GRAPH, 11, "cpu")
    ptr, col = graphs.csr(GRAPH, 11, "cpu")
    rows = torch.repeat_interleave(torch.arange(GRAPH["n_nodes"]),
                                   ptr[1:] - ptr[:-1])
    key = lambda s, r: torch.sort(r * GRAPH["n_nodes"] + s).values
    assert torch.equal(key(col, rows), key(snd, rcv))


def test_samples_are_graphsage_samples_of_the_csr():
    # Reddit's mean in-degree is about 492; this graph's is 200.
    ptr, col = graphs.csr({**GRAPH, "n_nodes": 5000,
                           "n_edges": 1_000_000}, 5, "cpu")
    fanout = (15, 10)
    gen = graphs.generator(BIG_SEED, 4, "cpu")
    s = graphs.sample(ptr, col, 64, fanout, gen)
    again = graphs.sample(ptr, col, 64, fanout,
                          graphs.generator(BIG_SEED, 4, "cpu"))
    assert all(torch.equal(s[k], again[k]) for k in ("node_ids", "senders"))
    ids, snd, rcv = s["node_ids"], s["senders"], s["receivers"]
    assert ids.unique().numel() == ids.numel()
    assert snd.max() < ids.numel() and rcv.max() < ids.numel()
    # Every node here has at least 15 in-neighbours: full fanouts.
    assert (ptr[1:] - ptr[:-1]).min() >= 15
    assert snd.numel() == 64 * 15 + 64 * 15 * 10
    # Each edge is an in-edge of its receiver in the CSR, and each
    # frontier entry's picks are distinct.
    g_snd, g_rcv = ids[snd], ids[rcv]
    for i in range(0, snd.numel(), 97):
        row = col[ptr[g_rcv[i]]:ptr[g_rcv[i] + 1]]
        assert bool((row == g_snd[i]).any())
    assert torch.equal(rcv[:64 * 15].view(64, 15)[:, 0], torch.arange(64))


def test_each_pick_is_a_distinct_neighbour():
    # 200 nodes, each with distinct in-neighbours: 30, or 5 for the
    # multiples of 10 (fewer than the fanout: all of them are taken).
    gen = torch.Generator().manual_seed(0)
    rows = [torch.randperm(200, generator=gen)[:5 if v % 10 == 0 else 30]
            for v in range(200)]
    ptr = torch.tensor([0] + [len(r) for r in rows]).cumsum(0)
    col = torch.cat(rows)
    s = graphs.sample(ptr, col, 40, (15,), graphs.generator(1, 4, "cpu"))
    g_snd = s["node_ids"][s["senders"]]
    g_rcv = s["node_ids"][s["receivers"]]
    for v in g_rcv.unique():
        picks = g_snd[g_rcv == v]
        assert picks.unique().numel() == picks.numel()
        assert picks.numel() == min(15, len(rows[v]))
        assert bool(torch.isin(picks, rows[v]).all())
