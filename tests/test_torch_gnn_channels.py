"""EquiformerV2 with its channels split over the ``model`` ranks (2-D GNN
partitioning), held to the reference's single-device model.

A (dp, tp) mesh's ranks run in this process, one thread a rank: each rank
builds its :class:`~repro_torch.models.gnn.graph.GraphShard` through
``launch.steps`` (its node block's receivers' edges, and its ``C / tp``
channels where ``tp`` divides ``C``) and runs the port's model on it.  The
collectives are the port's own autograd functions
(``distributed.comm``); only their transport is faked: a group's ranks
meet at a barrier, and a gather concatenates their tensors, a
reduce-scatter sums them (in rank order) and keeps the rank's slice, an
all-reduce sums them.  Each rank records its collectives as the ledger
does, and a layer's recompute tags its own ``_remat``.

For the smoke config (C 16, 4 heads, l_max 2, two layers), with its edges
whole, in 4 chunks and with its Wigner blocks pre-chunked, on the
meshes (1, 2), (2, 2), (1, 4), (2, 4), (4, 2) and
(2, 3) (3 does not divide 16: the channels stay whole, the reference's
rule):

* every rank's prediction is the reference's single-device ``forward``
  within 1e-6, and its loss the reference's within 1e-5;
* the ranks' gradients, summed as the train step's ``grad_dp`` sums them,
  are the reference's ``jax.grad`` within 1e-4 (each leaf relative to its
  largest, or to 1% of the model's largest);
* the first layer's outputs, the ranks' node rows and channel slices
  put back together, are the port's single-device layer on the padded
  graph within 1e-6;
* every rank's ledger is ``steps.gnn_policy_traffic`` to the byte, by
  (tag, kind), but for the gradient sum the step adds: ``gnn_gather`` at
  ``L2 * C / tp`` and ``C`` a layer, ``gnn_tp`` and ``gnn_tp_remat`` at
  ``steps.equiformer_channel_collectives``'s bytes, the readout's scalar
  psums aside.

On one rank the shard's prediction is the single-device model's on the
shard's batch, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models.gnn import equiformer_v2 as ref_eqv2
from repro.models.gnn.graph import GraphBatch as RefGraphBatch
from repro_torch import params as P
from repro_torch.configs import get_arch
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import make_policy
from repro_torch.launch import steps
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.common import REMAT_TAG
from repro_torch.models.gnn import equiformer_v2 as eqv2
from repro_torch.models.gnn.graph import GraphBatch
from repro_torch.tree import tree_paths, value_and_grad
from test_torch_gnn_policy import EDGE_CHUNKS, _batch

NAME = "equiformer-v2"
#: (dp, tp); 3 does not divide the smoke config's 16 channels.
MESHES = ((1, 2), (2, 2), (1, 4), (2, 4), (4, 2), (2, 3))
VARIANTS = ("nodes", "chunked", "pre_chunked")
#: The loss squares the prediction's error: its rounding runs to twice
#: the prediction's.
OUT_TOL, LOSS_TOL, GRAD_TOL, GRAD_FLOOR_SHARE = 1e-6, 1e-5, 1e-4, 1e-2
CASES = [(m, v) for m in MESHES for v in VARIANTS]


def _case_id(case) -> str:
    (dp, tp), variant = case
    return f"{dp}x{tp}-{variant}"


def _configs(variant: str):
    kw = {"edge_chunks": EDGE_CHUNKS} if variant != "nodes" else {}
    return (ref_get_arch(NAME).make_smoke_config(**kw),
            get_arch(NAME).make_smoke_config(**kw))


@functools.lru_cache(maxsize=None)
def _reference(variant: str) -> dict:
    """The reference's weights, batch, single-device prediction, loss and
    gradients."""
    cfg, _ = _configs(variant)
    params = ref_eqv2.init_params(cfg, jax.random.key(0))
    batch = _batch(NAME, variant, cfg)
    g = RefGraphBatch(**{k: ({l: jnp.asarray(w) for l, w in v.items()}
                             if k == "wigner" else jnp.asarray(v))
                         for k, v in batch.items()})
    pred = ref_eqv2.forward(cfg, params, g)
    (loss, _), grads = jax.value_and_grad(
        lambda q: ref_eqv2.loss_fn(cfg, q, g), has_aux=True)(params)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": np_tree(params), "batch": batch,
            "pred": np.asarray(pred), "loss": float(loss),
            "grads": np_tree(grads)}


# ---------------------------------------------------------------------------
# In-process ranks: one thread each, the collectives' transport faked
# ---------------------------------------------------------------------------

_ME = threading.local()


class _Group:
    """The ranks of one process group, meeting at a barrier."""

    def __init__(self, ranks):
        self.ranks = list(ranks)
        self.barrier = threading.Barrier(len(self.ranks), timeout=120)
        self.slots = [None] * len(self.ranks)

    def exchange(self, x: torch.Tensor) -> list:
        self.slots[self.ranks.index(_ME.rank)] = x
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _Mesh:
    """The node groups (one a ``model`` coordinate) and the channel groups
    (one a node block) of a (dp, tp) mesh; rank ``b * tp + t``."""

    def __init__(self, dp: int, tp: int):
        self.dp, self.tp = dp, tp
        self.node = [_Group(range(t, dp * tp, tp)) for t in range(tp)]
        self.model = [_Group(range(b * tp, (b + 1) * tp)) for b in range(dp)]

    def groups(self) -> list:
        return self.node + self.model


class _RankPolicy:
    """What ``launch.steps`` and ``shard_graph`` ask of a policy, for one
    rank of a ``("data", "model")`` mesh."""

    dp_axes, tp_axis, dp_spec = ("data",), "model", "data"

    def __init__(self, mesh: _Mesh, rank: int):
        self.mesh = mesh
        self.b, self.t = divmod(rank, mesh.tp)
        self.dp, self.tp = mesh.dp, mesh.tp
        self.n_devices = mesh.dp * mesh.tp

    def size(self, axes) -> int:
        return self.dp if axes == "data" else self.tp

    def coord(self, axes) -> int:
        return self.b if axes == "data" else self.t

    def group(self, axes) -> _Group:
        return self.mesh.node[self.t] if axes == "data" \
            else self.mesh.model[self.b]


def _note(kind: str, out: torch.Tensor, group: _Group, tag: str) -> None:
    _ME.ops.append(comm.CollectiveOp(
        kind, float(out.numel() * out.element_size()), len(group.ranks),
        tag + "".join(_ME.suffixes)))


def _gather(x, group, dim, tag=""):
    out = torch.cat(group.exchange(x), dim=dim).contiguous()
    _note("all-gather", out, group, tag)
    return out


def _sum(parts: list) -> torch.Tensor:
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _scatter(x, group, dim, tag=""):
    total = _sum(group.exchange(x))
    n = x.shape[dim] // len(group.ranks)
    out = total.narrow(dim, group.ranks.index(_ME.rank) * n, n).contiguous()
    _note("reduce-scatter", out, group, tag)
    return out


def _reduce(x, group, tag, op=torch.distributed.ReduceOp.SUM):
    assert op == torch.distributed.ReduceOp.SUM
    out = _sum(group.exchange(x)).clone()
    _note("all-reduce", out, group, tag)
    return out


@contextlib.contextmanager
def _retagged(suffix: str):
    _ME.suffixes.append(suffix)
    try:
        yield
    finally:
        _ME.suffixes.pop()


def _run_ranks(mesh: _Mesh, fn) -> list:
    """``fn(rank)`` on every rank of ``mesh``, one thread each, with the
    collectives' transport faked; their results in rank order."""
    n = mesh.dp * mesh.tp
    results, errors = [None] * n, []

    def main(rank: int) -> None:
        _ME.rank, _ME.ops, _ME.suffixes = rank, [], []
        try:
            results[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            for g in mesh.groups():
                g.barrier.abort()

    with pytest.MonkeyPatch.context() as mp:
        for name, fake in (("_gather", _gather), ("_scatter", _scatter),
                           ("_reduce", _reduce), ("retagged", _retagged),
                           ("group_size", lambda g: len(g.ranks)),
                           ("group_rank",
                            lambda g: g.ranks.index(_ME.rank))):
            mp.setattr(comm, name, fake)
        # Each rank's tensors are small: one intra-op thread, not a pool
        # shared by the ranks.
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            threads = [threading.Thread(target=main, args=(r,))
                       for r in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        finally:
            torch.set_num_threads(n_threads)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    return results


# ---------------------------------------------------------------------------
# The split model on every rank
# ---------------------------------------------------------------------------

def _shard(cfg, policy, batch: dict):
    return steps._shard_gnn_batch(NAME, cfg, policy, "cpu",
                                  GraphBatch(**batch))


@functools.lru_cache(maxsize=None)
def _split_run(case) -> dict:
    """Each rank's prediction, loss, gradients and ledger of one
    loss-and-gradients call, and its first layer's output."""
    (dp, tp), variant = case
    ref = _reference(variant)
    _, cfg = _configs(variant)
    mesh = _Mesh(dp, tp)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (steps._pad(ref["batch"]["node_feat"].shape[0]), cfg.L2,
         cfg.d_hidden)).astype(np.float32))

    def rank_fn(rank: int) -> dict:
        shard = _shard(cfg, _RankPolicy(mesh, rank), ref["batch"])
        tree = P.gnn_tree(cfg, ref["params"], device="cpu")
        model = eqv2.EquiformerV2(cfg, device="cpu")
        (loss, metrics), grads = value_and_grad(
            P.tree_loss(model, eqv2.loss_fn))(tree, shard)
        ops = list(_ME.ops)
        with torch.no_grad():
            pred = P.tree_loss(model, lambda m, g: m(g))(tree, shard)
            n, (lo, hi) = shard.n_nodes, shard.channels(cfg.d_hidden)
            rows = slice(rank // tp * n, (rank // tp + 1) * n)
            loaded = P.load_equiformer_v2(ref["params"], cfg, device="cpu")
            layer = loaded._layer(loaded.layers[0], x[rows, :, lo:hi],
                                  shard, shard.emask())
        return {"pred": pred.numpy(), "loss": float(metrics["loss"]),
                "grads": dict(tree_paths(grads)), "ops": ops,
                "rows": rows, "channels": (lo, hi), "layer": layer,
                "n_total": shard.n_total, "channel_ranks": shard.channel_ranks}

    return {"ranks": _run_ranks(mesh, rank_fn), "x": x, "cfg": cfg}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_split_prediction_and_gradients_match_the_reference(case):
    (dp, tp), variant = case
    ref = _reference(variant)
    ranks = _split_run(case)["ranks"]
    cfg = _split_run(case)["cfg"]
    assert {r["channel_ranks"] for r in ranks} == {
        tp if cfg.d_hidden % tp == 0 else 1}
    top = max(float(np.max(np.abs(g))) for _, g in tree_paths(ref["grads"]))
    for r in ranks:
        err = float(np.max(np.abs(r["pred"] - ref["pred"]))) / float(
            np.max(np.abs(ref["pred"])))
        assert err < OUT_TOL, err
        assert abs(r["loss"] - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    worst = (0.0, "")
    for path, want in tree_paths(ref["grads"]):
        got = sum(r["grads"][path].numpy().astype(np.float64) for r in ranks)
        err = float(np.max(np.abs(got - want))) / max(
            float(np.max(np.abs(want))), GRAD_FLOOR_SHARE * top)
        worst = max(worst, (err, "/".join(map(str, path))))
    print(f"{_case_id(case)}: worst gradient leaf {worst}")
    assert worst[0] < GRAD_TOL, worst


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_split_layer_equals_single_device(case):
    """The ranks' layer outputs, put back in place, against the port's
    single-device layer on the padded graph."""
    run = _split_run(case)
    cfg, x, ranks = run["cfg"], run["x"], run["ranks"]
    ref = _reference(case[1])
    g = GraphBatch(**ref["batch"]).to("cpu")
    pad = x.shape[0] - g.n_nodes
    full = dataclasses.replace(
        g, node_feat=torch.cat([g.node_feat, g.node_feat.new_zeros(
            (pad, g.node_feat.shape[1]))]),
        node_mask=torch.cat([g.nmask(), g.nmask().new_zeros(pad)]))
    model = P.load_equiformer_v2(ref["params"], cfg, device="cpu")
    with torch.no_grad():
        want = model._layer(model.layers[0], x, full, full.emask())
    got = torch.zeros_like(want)
    for r in ranks:
        lo, hi = r["channels"]
        got[r["rows"], :, lo:hi] = r["layer"]
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err < OUT_TOL, err


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_split_ledger_equals_the_traffic_model(case):
    (dp, tp), _ = case
    run = _split_run(case)
    cfg, ranks = run["cfg"], run["ranks"]
    policy = make_policy(AbstractMesh(("data", "model"), (dp, tp)))
    n_total = ranks[0]["n_total"]
    model = steps.gnn_policy_traffic(NAME, cfg, policy, n_total, 0)
    assert model.pop(("grad_dp", "all-reduce")) == 0.0
    split = steps.gnn_channel_ranks(NAME, cfg, policy)
    widths = {cfg.L2 * cfg.d_hidden // split, cfg.d_hidden}
    for r in ranks:
        by: dict = {}
        for op in r["ops"]:
            key = (op.tag, op.kind)
            by[key] = by.get(key, 0.0) + op.wire_bytes_per_chip
            if op.tag.startswith("gnn_gather") and op.kind == "all-gather":
                assert op.group_size == dp
                assert op.result_bytes / (4 * n_total) in widths
            if op.tag.startswith("gnn_tp"):
                assert op.group_size == tp
        by.pop(("gnn_readout", "all-reduce"), None)
        assert by == model, (by, model)
        tp_tags = {k for k in by if k[0].startswith("gnn_tp")}
        assert bool(tp_tags) == (split > 1)
        if split > 1:
            assert ("gnn_tp" + REMAT_TAG, "all-reduce") in tp_tags
    print(f"{_case_id(case)}: every rank's ledger {model}")


def test_one_rank_prediction_is_the_single_device_bit_for_bit():
    """World 1: the shard's prediction against the single-device model on
    the batch the shard holds (its nodes padded, its edges in order)."""
    ref = _reference("chunked")
    _, cfg = _configs("chunked")
    mesh = _Mesh(1, 1)

    def rank_fn(rank: int):
        shard = _shard(cfg, _RankPolicy(mesh, rank), ref["batch"])
        model = P.load_equiformer_v2(ref["params"], cfg, device="cpu")
        one = GraphBatch(**{f.name: getattr(shard, f.name)
                            for f in dataclasses.fields(GraphBatch)})
        with torch.no_grad():
            return model(shard), model(one)

    (got, want), = _run_ranks(mesh, rank_fn)
    assert torch.equal(got, want)
