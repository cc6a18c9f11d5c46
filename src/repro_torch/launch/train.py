"""Trainer: config -> data -> resilient loop -> checkpoints (the
reference's ``launch/train.py`` in PyTorch, on one device).

The three families train as the reference trains them, each through its
``loss_fn`` and one step builder (``optimizers.make_step``): the transformer with
chunked attention, group remat and AdamW on a cosine schedule with weight
decay 0.1 (the steps of ``transformer.make_train_step``), the GNNs and
DLRM with AdamW at a constant rate.
The state is ``(params, opt_state)``, params a tree of f32 tensors in the
reference's layout, so its checkpoints hold the reference's leaves.  The
weights come from the port's seeded draws (``params.draw_transformer``,
``params.gnn_params``, ``DLRM(generator=...)``), not the reference's PRNG.
Every step updates its state in place (``adamw(donate=True)``): a trainer
never reads the state it replaced.

``--device`` is ``cuda`` unless given ``cpu``; without a card the trainer
exits 2 and nothing falls back to the CPU.  DLRM's embedding bags run K6
on the card; the transformer and the GNNs run no hand-written kernel, as
the reference's training paths reach no Pallas kernel.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 128 --lr 3e-3 --checkpoint-every 100 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
      --steps 300 --fail-at 120 --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys
import tempfile
from functools import partial
from typing import Optional, Sequence

import numpy as np
import torch

from ..backend import resolve_device
from ..checkpoint.manager import CheckpointManager
from ..configs import get_arch
from ..data import synthetic
from ..distributed.resilience import FaultInjector, StepMonitor, run_resilient
from ..models import dlrm as dlrm_lib
from ..models import transformer as tf_lib
from ..models.gnn import equiformer_v2 as eqv2_lib
from ..models.gnn import gatedgcn as ggcn_lib
from ..models.gnn import gcn as gcn_lib
from ..models.gnn import meshgraphnet as mgn_lib
from ..models.gnn.graph import GraphBatch
from ..optim import compression
from ..optim.optimizers import adamw, cosine_schedule, make_step
from ..params import draw_transformer, gnn_params, module_tree, tensor_tree
from ..params import tree_loss

__all__ = ["gnn_batch", "run", "train", "build_parser", "main",
           "GNN_MODELS", "SETUPS", "TRAIN_BYTES_PER_PARAM"]

logger = logging.getLogger("repro_torch.train")

#: Per GNN arch: its module (for the loss) and its model class.
GNN_MODELS = {"gcn-cora": (gcn_lib, gcn_lib.GCN),
              "gatedgcn": (ggcn_lib, ggcn_lib.GatedGCN),
              "meshgraphnet": (mgn_lib, mgn_lib.MeshGraphNet),
              "equiformer-v2": (eqv2_lib, eqv2_lib.EquiformerV2)}

#: Bytes a trained f32 parameter holds on the device: itself, its
#: gradient and AdamW's two moments.
TRAIN_BYTES_PER_PARAM = 16


def _lm_setup(arch, args, dev: torch.device):
    cfg = arch.make_config() if args.full else arch.make_smoke_config()
    params = module_tree(draw_transformer(cfg, args.seed, device=dev,
                                          dtype=torch.float32))
    optimizer = adamw(cosine_schedule(args.lr, warmup=20, total=args.steps),
                      weight_decay=0.1, donate=True)
    if args.compress_grads:
        optimizer = compression.wrap_optimizer(optimizer)
    opt_state = optimizer.init(params)
    step_fn = make_step(partial(tf_lib.loss_fn, cfg), optimizer)

    def batch_fn(step):
        b = synthetic.lm_batch(args.seed, step, batch=args.batch,
                               seq=args.seq, vocab=cfg.vocab)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    return (params, opt_state), step_fn, batch_fn


def gnn_batch(arch_name: str, cfg, args) -> GraphBatch:
    """The reference trainer's one fixed synthetic graph (full-batch
    training), as numpy fields of a :class:`GraphBatch`."""
    n_classes = getattr(cfg, "n_classes", 3)
    ga = synthetic.power_law_graph(
        args.seed, n_nodes=args.gnn_nodes, n_edges=args.gnn_edges,
        d_feat=cfg.d_in, n_classes=n_classes,
        self_loops=arch_name != "equiformer-v2")
    kw = dict(node_feat=ga.node_feat, senders=ga.senders,
              receivers=ga.receivers, labels=ga.labels)
    if arch_name in ("gatedgcn", "meshgraphnet"):
        kw["edge_feat"] = np.ones((ga.n_edges, cfg.d_edge_in), np.float32)
    if arch_name == "meshgraphnet":
        rng = np.random.default_rng(args.seed)
        kw["labels"] = rng.standard_normal(
            (ga.n_nodes, cfg.d_out)).astype(np.float32)
    elif arch_name == "equiformer-v2":
        from ..data.wigner import rotation_to_z, wigner_stack
        rng = np.random.default_rng(args.seed)
        pos = rng.standard_normal((ga.n_nodes, 3))
        vecs = pos[ga.senders] - pos[ga.receivers]
        wig = wigner_stack(np.stack([rotation_to_z(v) for v in vecs]),
                           cfg.l_max, m_max=cfg.m_max)
        kw["wigner"] = {l: w.astype(np.float32) for l, w in wig.items()}
        kw["positions"] = pos.astype(np.float32)
        kw["labels"] = rng.standard_normal((1, cfg.d_out)).astype(np.float32)
    return GraphBatch(**kw)


def _gnn_setup(arch, args, dev: torch.device):
    cfg = arch.make_config() if args.full else arch.make_smoke_config()
    module, model_cls = GNN_MODELS[arch.name]
    params = tensor_tree(gnn_params(cfg, args.seed), device=dev)
    optimizer = adamw(args.lr, donate=True)
    opt_state = optimizer.init(params)
    g = gnn_batch(arch.name, cfg, args).to(dev)
    step_fn = make_step(tree_loss(model_cls(cfg, device=dev),
                                  module.loss_fn), optimizer)
    return (params, opt_state), step_fn, lambda step: g


def _dlrm_setup(arch, args, dev: torch.device):
    cfg = arch.make_config() if args.full else arch.make_smoke_config()
    if dev.type == "cuda":
        need = TRAIN_BYTES_PER_PARAM * cfg.param_count()
        free, _ = torch.cuda.mem_get_info(dev)
        if need > free:
            raise MemoryError(
                f"{cfg.name}: training holds {need / 1e9:.2f} GB (f32 "
                f"weights, gradients and two moments, "
                f"{TRAIN_BYTES_PER_PARAM} B a parameter), {free / 1e9:.2f} "
                f"GB free on {dev}")
    model = dlrm_lib.DLRM(cfg, device=dev, generator=torch.Generator(
        dev).manual_seed(args.seed))
    params = module_tree(model)   # the module's own tensors: no copy
    optimizer = adamw(args.lr, donate=True)
    opt_state = optimizer.init(params)
    step_fn = make_step(tree_loss(model, dlrm_lib.loss_fn), optimizer)

    def batch_fn(step):
        b = synthetic.criteo_batch(args.seed, step, batch=args.batch,
                                   n_dense=cfg.n_dense,
                                   vocab_sizes=cfg.vocab_sizes,
                                   multi_hot=cfg.multi_hot)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    return (params, opt_state), step_fn, batch_fn


SETUPS = {"lm": _lm_setup, "gnn": _gnn_setup, "recsys": _dlrm_setup}


def train(args) -> tuple[object, list[dict]]:
    """The run of ``args``: (final state, metrics history)."""
    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    state, step_fn, batch_fn = SETUPS[arch.family](arch, args, dev)
    ckpt = CheckpointManager(
        args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_"), keep=3)
    injector = FaultInjector(frozenset(args.fail_at or []))
    state, history = run_resilient(
        state=state, step_fn=step_fn, batch_fn=batch_fn, n_steps=args.steps,
        checkpoint_manager=ckpt, checkpoint_every=args.checkpoint_every,
        injector=injector, monitor=StepMonitor())
    if history:
        first, last = history[0], history[-1]
        logger.info("loss: %.4f -> %.4f over %d steps",
                    first.get("loss", float("nan")),
                    last.get("loss", float("nan")), len(history))
    return state, history


def run(args) -> list[dict]:
    """The reference's ``run``: the metrics history of :func:`train`."""
    return train(args)[1]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=None,
                    help="inject worker failures at these steps")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--gnn-nodes", type=int, default=256)
    ap.add_argument("--gnn-edges", type=int, default=1024)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu; without a card and "
                         "without --device cpu the trainer exits 2")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"repro_torch.launch.train: {exc}", file=sys.stderr)
        return 2
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
