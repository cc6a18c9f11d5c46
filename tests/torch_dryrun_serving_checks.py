"""The dry run's serving plans run for real on 4 gloo ranks, for
``tests/test_torch_dryrun_serving.py``.

NOT collected by pytest (its name has no ``test_`` prefix).

    python tests/torch_dryrun_serving_checks.py OUT.pkl

starts 4 ranks (``repro_torch.launch.mesh.spawn``, gloo, one CPU thread a
rank) and writes every rank's results:

* ``lm/<arch>``: on the (2, 2) mesh, the plans of ``prefill_32k`` and
  ``decode_32k`` (``launch.steps.plan`` at smoke sizes) with FSDP forced
  (``SERVE_FSDP_BYTES`` 0, every leaf of 1 KiB or more split over dp), so
  each rank's step builds its model from FSDP blocks and gathers one layer
  at a time: the prefill's last logits and one decode step's after it,
  gathered over dp, beside the single-device ``make_prefill_step`` /
  ``make_serve_step`` on the whole weights, and the ledger's bytes by tag;
* ``retrieval``: the ``retrieval_cand`` plan's step on the (2, 2) mesh,
  each rank scoring its quarter of the candidates and the top-k merged
  across ranks, beside ``dlrm.score_candidates`` on every candidate and
  ``torch.topk``;
* ``pod``: a decode whose cache is split over ``("data", "model")`` of a
  (2, 1, 2) ``("pod", "data", "model")`` mesh (the layout of
  ``long_500k``), four steps beside the single-device decode.

This file imports neither jax nor the reference.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
from functools import partial

import numpy as np
import torch

LM_ARCHS = ("arctic-480b", "gemma2-2b")
#: Prompt, cache and batch of the served LM cells.
PROMPT, MAX_SEQ, BATCH = 12, 32, 4
#: FSDP's threshold in the served plans: the smoke matrices split over dp.
FSDP_MIN_BYTES = 1024
N_CANDIDATES = 1024
POD_STEPS = 4


def _tokens(cfg, b: int, s: int) -> torch.Tensor:
    rng = np.random.default_rng(1)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                           dtype=torch.int32)


def _lm(name: str, policy) -> dict:
    from repro_torch import params
    from repro_torch.configs import get_arch
    from repro_torch.distributed import comm
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.tree import is_spec, tree_paths

    arch = get_arch(name)
    cfg = arch.make_smoke_config()
    if cfg.moe is not None:
        # Capacity for every token: expert parallelism sizes an expert's
        # slots from the rank's tokens, one device from all of them, so
        # the two drop different tokens at a tighter capacity.
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    tree = params.transformer_params(cfg, seed=0)
    tokens = _tokens(cfg, BATCH, PROMPT + 1)
    cpu = torch.device("cpu")

    def cell(shape: str, seq: int, **kw):
        spec = arch.shapes[shape]
        spec = dataclasses.replace(
            spec, params={**spec.params, "seq": seq, "batch": BATCH})
        return steps.plan(arch, spec, policy, cfg=cfg, **kw)

    prefill = cell("prefill_32k", PROMPT, max_seq=MAX_SEQ)
    decode = cell("decode_32k", MAX_SEQ)
    blocks = params.shard_transformer_tree(
        tree, cfg, policy, specs=prefill.specs[0], device=cpu,
        dtype=torch.float32)
    fn_p, _ = prefill.step(cpu)
    fn_d, _ = decode.step(cpu)
    with comm.recording() as ledger:
        lp, cache = fn_p(blocks, tokens[:, :PROMPT])
        ld, _ = fn_d(blocks, cache, tokens[:, PROMPT:], PROMPT)
    dp = policy.group(policy.dp_axes)

    model = params.load_transformer(tree, cfg, device=cpu)
    lp1, cache1 = tr.make_prefill_step(cfg, max_seq=MAX_SEQ)(
        model, tokens[:, :PROMPT])
    ld1, _ = tr.make_serve_step(cfg, MAX_SEQ)(model, cache1,
                                              tokens[:, PROMPT:], PROMPT)
    return {"prefill": comm.all_gather(lp, dp, 0).numpy(),
            "decode": comm.all_gather(ld, dp, 0).numpy(),
            "prefill_1": lp1.numpy(), "decode_1": ld1.numpy(),
            "by_tag": ledger.by_tag(),
            "fsdp_leaves": sum(policy.dp_spec in spec for _, spec in
                               tree_paths(prefill.specs[0], is_spec))}


def _retrieval(policy) -> dict:
    from repro_torch import params
    from repro_torch.configs import get_arch
    from repro_torch.distributed import comm
    from repro_torch.launch import steps
    from repro_torch.models import dlrm

    arch = get_arch("dlrm-mlperf")
    cfg = arch.make_smoke_config()
    spec = arch.shapes["retrieval_cand"]
    spec = dataclasses.replace(
        spec, params={**spec.params, "n_candidates": N_CANDIDATES})
    plan = steps.plan(arch, spec, policy, cfg=cfg)
    fn, _ = plan.step(torch.device("cpu"))
    tree = params.dlrm_params(cfg, seed=0)
    rng = np.random.default_rng(2)
    nc = plan.meta["n_candidates"]
    cand = torch.as_tensor(rng.standard_normal((nc, cfg.embed_dim)),
                           dtype=torch.float32)
    query = {"dense": torch.as_tensor(rng.random((1, cfg.n_dense)),
                                      dtype=torch.float32)}
    n = nc // policy.n_devices
    lo = policy.coord(policy.all_axes) * n
    model = params.shard_dlrm(tree, cfg, policy, device="cpu")
    with comm.recording() as ledger:
        vals, idx = fn(model, query, cand[lo:lo + n])
    whole = params.load_dlrm(tree, cfg, device="cpu")
    v1, i1 = torch.topk(dlrm.score_candidates(whole, query, cand),
                        steps.RETRIEVAL_TOP_K)
    return {"vals": vals.numpy(), "idx": idx.numpy(), "vals_1": v1.numpy(),
            "idx_1": i1.numpy(), "by_tag": ledger.by_tag()}


def _pod() -> dict:
    from repro_torch import params
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tr

    policy = make_policy(make_test_mesh((2, 1, 2), ("pod", "data", "model")))
    cfg = get_arch("gemma2-2b").make_smoke_config()
    tree = params.transformer_params(cfg, seed=0)
    tokens = _tokens(cfg, 1, POD_STEPS)
    dec = tr.DecodePolicy(cache_seq_axes=("data", "model"), batch_axes=())
    model = params.shard_transformer(tree, cfg, policy, device="cpu")
    step = tr.make_serve_step(cfg, MAX_SEQ, policy=policy, decode=dec)
    cache = tr.init_cache(cfg, 1, MAX_SEQ, device="cpu", policy=policy,
                          decode=dec)
    whole = params.load_transformer(tree, cfg, device="cpu")
    step1 = tr.make_serve_step(cfg, MAX_SEQ)
    cache1 = tr.init_cache(cfg, 1, MAX_SEQ, device="cpu")
    got, want = [], []
    for i in range(POD_STEPS):
        lg, cache = step(model, cache, tokens[:, i:i + 1], i)
        lg1, cache1 = step1(whole, cache1, tokens[:, i:i + 1], i)
        got.append(lg.numpy())
        want.append(lg1.numpy())
    return {"got": np.stack(got), "want": np.stack(want),
            "cache_shards": policy.size(dec.cache_seq_axes)}


def rank_main(rank: int, world: int) -> dict:
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh

    steps.SERVE_FSDP_BYTES = 0
    steps.fsdp_specs = partial(sharding.fsdp_specs,
                               min_bytes=FSDP_MIN_BYTES)
    policy = make_policy(make_test_mesh((2, 2), ("data", "model")))
    out = {f"lm/{name}": _lm(name, policy) for name in LM_ARCHS}
    out["retrieval"] = _retrieval(policy)
    out["pod"] = _pod()
    return out


def main(argv: list[str]) -> int:
    from repro_torch.launch.mesh import spawn

    results = spawn(rank_main, 4, backend="gloo")
    with open(argv[0], "wb") as f:
        pickle.dump(results, f)
    print(f"SERVING CHECKS DONE on {len(results)} ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
