"""The port's train steps under a sharding policy, on gloo ranks.

NOT collected by pytest (its name has no ``test_`` prefix).
``tests/test_torch_policy_train.py`` writes the inputs (the reference's
``init_params`` as numpy, the batches and the cases) into a pickle and
runs

    python tests/torch_policy_train_checks.py JOB IN_PICKLE OUT_PICKLE

which starts the job's gloo ranks (``repro_torch.launch.mesh.spawn``, one
CPU thread a rank) and writes rank 0's results:

* ``lm`` (8 ranks): for each case (a smoke config, a mesh, the CE path)
  three steps of ``launch.steps.lm_train_cell`` (``transformer.
  make_train_step(policy=)`` with FSDP at the pickle's ``min_bytes``):
  every step's loss, the first step's ``mu`` and the last step's
  parameters and moments gathered whole, and the first step's ledger by
  tag;
* ``dlrm`` (8 ranks): three steps of ``launch.steps.dlrm_train_cell`` on
  the (2, 4) mesh, the same records, and the largest entry of any zero
  row on any rank;
* ``gnn`` (8 ranks): for each case (a GNN smoke config, a mesh, a
  readout) three steps of ``launch.steps.gnn_train_cell(policy=)`` on the
  global batch, the same records (the state is replicated: rank 0's
  tree), every rank's first-step ledger, and the shard's padded node
  count and every rank's local node and edge counts;
* ``gnn1`` (1 rank): for each model, three steps of the world-1 policy
  cell and of the single-device cell (``policy=None``, on the shard's
  padded batch) from the same weights: losses and final parameters of
  both, the policy step's first moments and ledger;
* ``draw4`` / ``draw8`` (4 / 8 ranks): every rank's blocks of
  ``params.shard_transformer_tree(None, ...)`` with its index along each
  leaf's spec axes.

This file imports neither jax nor the reference.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np
import torch


def _policy(shape):
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.launch.mesh import make_test_mesh
    return make_policy(make_test_mesh(shape, ("data", "model")))


def _whole(t: torch.Tensor, spec: tuple, policy) -> np.ndarray:
    """The global array of this rank's block ``t`` laid out by ``spec``."""
    from repro_torch.distributed import comm
    for d, entry in enumerate(spec):
        if entry is not None:
            t = comm.all_gather(t.contiguous(), policy.group(entry), d)
    return t.detach().numpy().copy()


def _whole_tree(tree, specs, policy):
    if isinstance(tree, dict):
        return {k: _whole_tree(tree[k], specs[k], policy) for k in tree}
    if isinstance(tree, list):
        return [_whole_tree(t, s, policy) for t, s in zip(tree, specs)]
    return _whole(tree, specs, policy)


def _state(params, opt_state, specs, policy) -> dict:
    return {"params": _whole_tree(params, specs, policy),
            "mu": _whole_tree(opt_state.mu, specs, policy),
            "nu": _whole_tree(opt_state.nu, specs, policy)}


def _run(cell, batch, policy, steps: int, view=lambda tree: tree) -> dict:
    """``steps`` steps of ``cell``; ``view`` maps a tree of blocks to the
    blocks of the spec tree (DLRM drops its zero rows)."""
    from repro_torch.distributed import comm
    specs = cell.specs
    params, state = cell.params, cell.opt_state
    losses, first_mu, ledger = [], None, None
    for i in range(steps):
        with comm.recording() as rec:
            params, state, metrics = cell.step(params, state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            ledger = [(op.kind, op.tag, op.result_bytes, op.group_size,
                       op.wire_bytes_per_chip) for op in rec.ops]
            if specs is not None:
                first_mu = _whole_tree(view(state.mu), specs, policy)
    return {"losses": losses, "first_mu": first_mu, "ledger": ledger,
            "params_out": params, "state_out": state}


def job_lm(rank: int, world: int, data: dict) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr

    out = {}
    defaults = (tr._CE_CHUNK_THRESHOLD, tr._CE_CHUNK)
    for case in data["cases"]:
        name, shape, chunked = case
        policy = _policy(shape)
        arch = get_arch(name)
        cfg = arch.make_smoke_config()
        tr._CE_CHUNK_THRESHOLD, tr._CE_CHUNK = (
            data["chunking"] if chunked else defaults)
        cell = steps.lm_train_cell(arch, "train_4k", policy,
                                   data["params"][name], cfg=cfg,
                                   device="cpu", min_bytes=data["min_bytes"])
        batch = {k: torch.as_tensor(v)
                 for k, v in data["batch"][name].items()}
        res = _run(cell, batch, policy, data["steps"])
        res.update(_state(res.pop("params_out"), res.pop("state_out"),
                          cell.specs, policy))
        out[case] = res
    tr._CE_CHUNK_THRESHOLD, tr._CE_CHUNK = defaults
    return out


def job_dlrm(rank: int, world: int, data: dict) -> dict:
    from repro_torch.distributed import comm
    from repro_torch.launch import steps

    policy = _policy(data["shape"])
    cfg = data["port_cfg"]
    cell = steps.dlrm_train_cell("dlrm-mlperf", "train_batch", policy,
                                 data["params"], cfg=cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in data["batch"].items()}
    rows = [v // policy.size(s[0]) if s[0] is not None else v
            for v, s in zip(cfg.vocab_sizes, cell.specs["tables"])]

    def strip(tree):
        return {**tree, "tables": [t[:r] for t, r in
                                   zip(tree["tables"], rows)]}

    res = _run(cell, batch, policy, data["steps"], view=strip)
    params, state = res.pop("params_out"), res.pop("state_out")
    pad = max([float(t[r:].abs().max()) for t, r in
               zip(params["tables"], rows) if t.shape[0] > r] + [0.0])
    pad = float(comm.all_reduce(torch.tensor(pad), policy.group(
        policy.all_axes), "max"))
    res.update(_state(strip(params), type(state)(
        state.step, strip(state.mu), strip(state.nu)), cell.specs, policy))
    res["pad_max"] = pad
    return res


def _gnn_cell(name: str, shape, readout: str, data: dict, policy):
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models.gnn.graph import GraphBatch

    cfg = get_arch(name).make_smoke_config(**data["cfg_kw"][(name,
                                                             readout)])
    cell = steps.gnn_train_cell(name, "full_graph_sm", policy,
                                data["params"][(name, readout)], cfg=cfg,
                                device="cpu")
    return cell, GraphBatch(**data["batch"][(name, readout)])


def job_gnn(rank: int, world: int, data: dict) -> dict:
    from repro_torch.distributed import comm

    out = {}
    for case in data["cases"]:
        name, shape, readout = case
        policy = _policy(shape)
        cell, g = _gnn_cell(name, shape, readout, data, policy)
        res = _run(cell, g, policy, data["steps"])
        res.update(_state(res.pop("params_out"), res.pop("state_out"),
                          cell.specs, policy))
        res["rank_ledgers"] = [None] * world
        torch.distributed.all_gather_object(
            res["rank_ledgers"], res["ledger"],
            group=policy.group(policy.all_axes))
        shard = cell.meta["shard"](g)
        sizes = torch.tensor([[shard.n_nodes, shard.n_edges]])
        res["n_total"] = shard.n_total
        res["sizes"] = comm.all_gather(sizes, policy.group(
            policy.all_axes)).tolist()
        out[case] = res
    return out


def job_gnn1(rank: int, world: int, data: dict) -> dict:
    import dataclasses

    from repro_torch.models.gnn.graph import GraphBatch
    from repro_torch.tree import tree_map

    out = {}
    policy = _policy((1, 1))
    for case in data["cases"]:
        name, _, readout = case
        got = {}
        for kind, pol in (("policy", policy), ("single", None)):
            cell, g = _gnn_cell(name, (1, 1), readout, data, pol)
            if pol is None:
                # The single-device step on the batch the shard trains on
                # (its nodes padded, its edges in the global order).
                g = GraphBatch(**{f.name: getattr(shard, f.name) for f in
                                  dataclasses.fields(GraphBatch)})
            else:
                shard = cell.meta["shard"](g)
            res = _run(cell, g.to("cpu"), pol, data["steps"])
            res["params"] = tree_map(lambda t: t.detach().numpy().copy(),
                                     res.pop("params_out"))
            del res["state_out"]
            got[kind] = res
        out[case] = got
    return out


def _draw(rank: int, world: int, data: dict) -> dict:
    from repro_torch import params as P
    from repro_torch.distributed.sharding import spec_axes
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    from repro_torch.tree import is_spec, tree_paths

    policy = _policy(data["shapes"][world])
    out = {}
    for name in data["names"]:
        cfg = get_arch(name).make_smoke_config()
        specs = tr.train_pspecs(cfg, policy, min_bytes=data["min_bytes"])
        tree = P.shard_transformer_tree(None, cfg, policy, specs=specs,
                                        device="cpu", seed=data["seed"])
        laid = dict(tree_paths(specs, is_spec))
        out[name] = {path: (spec_axes(laid[path], policy),
                            policy.coord(spec_axes(laid[path], policy)),
                            leaf.numpy().copy())
                     for path, leaf in tree_paths(tree, is_spec)}
    return out


def job_draw4(rank: int, world: int, data: dict) -> dict:
    return _draw(rank, world, data)


def job_draw8(rank: int, world: int, data: dict) -> dict:
    return _draw(rank, world, data)


JOBS = {"lm": (job_lm, 8), "dlrm": (job_dlrm, 8), "gnn": (job_gnn, 8),
        "gnn1": (job_gnn1, 1), "draw4": (job_draw4, 4),
        "draw8": (job_draw8, 8)}


def rank_main(rank: int, world: int, job: str, path: str):
    with open(path, "rb") as f:
        data = pickle.load(f)
    return JOBS[job][0](rank, world, data)


def main(argv: list[str]) -> int:
    from repro_torch.launch.mesh import spawn

    job, src, dst = argv
    results = spawn(rank_main, JOBS[job][1], backend="gloo",
                    args=(job, src))
    keep = results if job.startswith("draw") else results[0]
    with open(dst, "wb") as f:
        pickle.dump(keep, f)
    print(f"PORT {job} DONE on {len(results)} ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
