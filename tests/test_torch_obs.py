"""``repro_torch.obs``: spans that cost a flag check with no profiler and are
user annotations with one, the ``layout.*`` counters of
``steps.subgraph_batch`` against a sampled batch's real and padded sizes,
and the collectives' ``comm.<kind>.<tag>`` spans on two gloo ranks."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.data import synthetic
from repro_torch.data.sampler import build_csr, sample_subgraph
from repro_torch.distributed import comm
from repro_torch.launch import mesh, steps

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _annotations(prof) -> list:
    return [ev.name() for ev in prof.profiler.kineto_results.events()
            if ev.is_user_annotation()]


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    ctx = obs.span(obs.STEP)
    assert ctx is obs.span(obs.SEGMENT_SUM)
    with ctx, obs.span(obs.STEP):
        torch.ones(3).sum()


def test_span_with_a_profiler_is_a_user_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span(obs.STEP):
            with obs.span(obs.FORWARD):
                torch.ones(3).sum()
    assert _annotations(prof) == [obs.STEP, obs.FORWARD]


def test_span_names_are_fixed_and_distinct():
    names = [v for k, v in vars(obs).items()
             if k.isupper() and isinstance(v, str)]
    assert len(names) == 15
    names += list(comm.SPANS.values())
    assert len(set(names)) == len(names)
    assert all(n == "step" or n.startswith(("step.", "remat.", "mp.",
                                            "eqv2.", "comm."))
               for n in names)


def test_counters_count_reset_and_refuse_an_unknown_name():
    obs.reset_counters()
    obs.count("layout.batches")
    obs.count("layout.node_rows", 512)
    c = obs.counters()
    assert c["layout.batches"] == 1 and c["layout.node_rows"] == 512
    c["layout.batches"] = 99  # a copy
    assert obs.counters()["layout.batches"] == 1
    with pytest.raises(KeyError):
        obs.count("layout.unknown")
    obs.reset_counters()
    assert set(obs.counters().values()) == {0}


@pytest.mark.parametrize("arch", ["gcn-cora", "gatedgcn", "meshgraphnet",
                                  "equiformer-v2"])
def test_subgraph_batch_counts_its_real_and_padded_rows(arch):
    cfg = get_arch(arch).make_smoke_config()
    ga = synthetic.power_law_graph(0, n_nodes=300, n_edges=2400,
                                   d_feat=cfg.d_in, n_classes=3,
                                   self_loops=False)
    rng = np.random.default_rng(1)
    labels = ga.labels
    if arch == "meshgraphnet":
        labels = rng.standard_normal((300, cfg.d_out)).astype(np.float32)
    elif arch == "equiformer-v2":
        labels = rng.standard_normal((1, cfg.d_out)).astype(np.float32)
    positions = rng.standard_normal((300, 3))
    n_pad, e_pad = steps.sampled_subgraph_sizes(8, (3, 2))
    csr = build_csr(ga.senders, ga.receivers, ga.n_nodes)
    subs = [sample_subgraph(csr, rng.choice(300, 8, replace=False), (3, 2),
                            rng=rng, n_pad=n_pad, e_pad=e_pad)
            for _ in range(2)]
    obs.reset_counters()
    for sub in subs:
        steps.subgraph_batch(arch, cfg, sub, ga.node_feat, labels,
                             positions=positions)
    c = obs.counters()
    assert c["layout.batches"] == 2
    assert c["layout.node_rows"] == 2 * n_pad
    assert c["layout.edge_rows"] == 2 * e_pad
    assert c["layout.real_node_rows"] == sum(s.n_real_nodes for s in subs)
    assert c["layout.real_edge_rows"] == sum(s.n_real_edges for s in subs)
    assert 0 < c["layout.real_node_rows"] < c["layout.node_rows"]
    assert c["layout.host_ns"] > 0
    obs.reset_counters()


def _tags_in_the_port() -> set:
    tags = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "tag" and isinstance(kw.value, ast.Constant):
                        tags.add(kw.value.value)
    return tags


def test_every_callers_tag_has_a_span_of_its_own():
    found = _tags_in_the_port()
    assert "grad_dp" in found and "gnn_tp" in found
    assert found <= set(comm.TAGS)
    for kind in comm.KINDS:
        assert comm.SPANS[kind, ""] == f"comm.{kind}"
        for tag in comm.TAGS:
            assert comm.SPANS[kind, tag] == f"comm.{kind}.{tag}"


def _collectives(rank: int) -> list:
    x = torch.arange(4.0).reshape(2, 2) + rank
    y = x.clone().requires_grad_()
    g = comm.all_gather(y, None, tag="gnn_tp")
    g.sum().backward()  # the reduce-scatter, tagged alike
    comm.all_reduce(x, None, tag="grad_norm")
    comm.psum(x, None, tag="not_a_tag")
    comm.all_to_all(torch.arange(2.0) + rank, None)
    comm.ring_hop(x, None)
    comm.all_reduce_grads([x.clone()], None, tag="grad_dp")
    return [float(y.grad.sum())]


def _collectives_rank(rank: int, world: int) -> tuple:
    untraced = _collectives(rank)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _collectives(rank)
    # The backend's own annotations (``gloo:all_gather``) are not ours.
    return untraced == traced, [n for n in _annotations(prof)
                                if n.startswith("comm.")]


def test_collectives_run_in_their_spans_on_two_gloo_ranks():
    for same, seen in mesh.spawn(_collectives_rank, 2, backend="gloo"):
        assert same
        assert seen == [
            "comm.all-gather.gnn_tp", "comm.reduce-scatter.gnn_tp",
            "comm.all-reduce.grad_norm", "comm.all-reduce",
            "comm.all-to-all", "comm.collective-permute",
            "comm.all-reduce.grad_dp"]
