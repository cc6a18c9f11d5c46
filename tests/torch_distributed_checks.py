"""The port's distributed battery: 8 gloo ranks on a (2, 4) mesh.

NOT collected by pytest (its name has no ``test_`` prefix).
``tests/test_torch_distributed.py`` computes the reference's single-device
outputs with JAX, writes them beside the inputs into a pickle, and runs

    python tests/torch_distributed_checks.py CHECK PICKLE

which starts 8 ranks (``repro_torch.launch.mesh.spawn``, gloo, one CPU
thread a rank), runs CHECK's rank program in each, and exits 0 when every
rank's comparison held; each check twins one of
``tests/distributed_checks.py``.  Ledger numbers are printed as ``#
ledger ...`` lines.  This file imports neither jax nor the reference.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np
import torch

#: The reference battery's tolerance on every sharded output.
REL_TOL = 2e-4
#: Gradients against single-device autograd.
GRAD_TOL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _policy(shape=(2, 4), axes=("data", "model")):
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.launch.mesh import make_test_mesh
    return make_policy(make_test_mesh(shape, axes))


def _lm_forward(data: dict, label: str) -> list[str]:
    """A transformer's logits under the (2, 4) policy, gathered, against
    the reference's single-device forward."""
    from repro_torch import params
    from repro_torch.distributed import comm
    from repro_torch.models import transformer as tr

    policy = _policy()
    cfg = data["cfg"]
    model = params.shard_transformer(data["params"], cfg, policy,
                                     device="cpu")
    tokens = torch.as_tensor(data["tokens"])
    with comm.recording() as ledger:
        local = tr.forward(cfg, model, tokens, policy=policy)
    got = tr.gather_logits(cfg, local, policy)
    err = _rel(got.numpy(), data["expect"])
    assert err < REL_TOL, (label, err)
    return [f"{label}: rel err {err:.3e} (tolerance {REL_TOL:.0e}); "
            f"ledger {ledger.summary()}"]


def check_moe_ep(rank: int, world: int, data: dict) -> list[str]:
    """MoE expert parallelism with TP heads (4 heads, 8 experts, tp 4)."""
    from repro_torch.core import comm_model
    from repro_torch.distributed import comm
    lines = _lm_forward(data, "moe ep")
    # The expert all-to-alls of one forward, beside the EP model: capacity
    # padding (C slots an expert, not top_k tokens) keeps them apart.
    from repro_torch import params
    from repro_torch.models import moe as moe_lib
    cfg = data["cfg"]
    policy = _policy()
    model = params.shard_transformer(data["params"], cfg, policy,
                                     device="cpu")
    x = torch.as_tensor(data["moe_x"])
    with comm.recording() as ledger:
        moe_lib.moe_ffn_ep(model.layers[0].moe, x, cfg.moe,
                           group=policy.group("model"))
    a2a = ledger.by_kind().get("all-to-all", 0.0)
    modelled = comm_model.moe_dispatch_sync(
        x.shape[0], cfg.d_model, cfg.moe.top_k, policy.tp, 1,
        dtype_bytes=4).total("ici")
    lines.append(f"# ledger moe layer all-to-all {a2a:.0f} B a rank vs "
                 f"moe_dispatch_sync {modelled:.0f} B")
    return lines


def check_ctx(rank: int, world: int, data: dict) -> list[str]:
    """Context parallelism: 3 heads on tp 4."""
    return _lm_forward(data, "ctx")


def check_decode(rank: int, world: int, data: dict) -> list[str]:
    """Sharded decode (window (8, None)) through 16 steps, every step's
    logits against the reference's; the sharded prefill against the last
    step."""
    from repro_torch import params
    from repro_torch.distributed import comm
    from repro_torch.models import transformer as tr

    policy = _policy()
    cfg = data["cfg"]
    dec = tr.DecodePolicy(cache_seq_axes=("model",), batch_axes=("data",))
    model = params.shard_transformer(data["params"], cfg, policy,
                                     device="cpu")
    tokens = torch.as_tensor(data["tokens"])
    b, s = tokens.shape
    step = tr.make_serve_step(cfg, s, policy=policy, decode=dec)
    cache = tr.init_cache(cfg, b, s, device="cpu", policy=policy,
                          decode=dec)
    worst = 0.0
    group = policy.group("data")
    for i in range(s):
        lg, cache = step(model, cache, tokens[:, i:i + 1], i)
        got = comm.all_gather(lg, group, 0)
        err = _rel(got.numpy(), data["expect"][i])
        assert err < REL_TOL, ("decode", i, err)
        worst = max(worst, err)
    # Prefill against decode: the whole prompt against the last step, and
    # 12 tokens (past the window of 8) continued by 4 decode steps.
    prefill = tr.make_prefill_step(cfg, max_seq=s, policy=policy, decode=dec)
    lp, _ = prefill(model, tokens)
    err_p = _rel(comm.all_gather(lp, group, 0).numpy(), data["expect"][-1])
    assert err_p < REL_TOL, ("prefill", err_p)
    lp, cache = prefill(model, tokens[:, :12])
    err_p = max(err_p, _rel(comm.all_gather(lp, group, 0).numpy(),
                            data["expect"][11]))
    for i in range(12, s):
        lg, cache = step(model, cache, tokens[:, i:i + 1], i)
        err_p = max(err_p, _rel(comm.all_gather(lg, group, 0).numpy(),
                                data["expect"][i]))
    assert err_p < REL_TOL, ("prefill then decode", err_p)
    return [f"decode: {s} steps, worst rel err {worst:.3e}; prefill vs "
            f"decode {err_p:.3e} (tolerance {REL_TOL:.0e})"]


def _spmm_inputs(data: dict):
    h = torch.as_tensor(data["h"])
    return h, data["snd"], data["rcv"], data["wgt"], data["n_nodes"]


def check_ring(rank: int, world: int, data: dict) -> list[str]:
    """Ring and all-gather SpMM on an 8-rank ring: outputs against the
    segment-sum oracle, gradients of sum(out^2) against single-device
    autograd, and the ledger against the traffic models exactly."""
    from repro_torch.core import comm_model
    from repro_torch.core.validation import validate_traffic
    from repro_torch.distributed import comm
    from repro_torch.distributed import ring
    from repro_torch.models.gnn.layers import gather_scatter_sum

    policy = _policy((8,), ("x",))
    group = policy.group("x")
    n = comm.group_size(group)
    h, snd, rcv, wgt, N = _spmm_inputs(data)
    F = h.shape[1]
    rp = ring.partition_edges_ring(snd, rcv, wgt, N, n)
    gp = ring.partition_edges_gather(snd, rcv, wgt, N, n)
    me = comm.group_rank(group)
    rows = slice(me * rp.n_local, (me + 1) * rp.n_local)
    ref = torch.as_tensor(data["expect"])

    # Single-device autograd of sum(out^2).
    h1 = h.clone().requires_grad_(True)
    out1 = gather_scatter_sum(h1, torch.as_tensor(snd), torch.as_tensor(rcv),
                              N, edge_weight=torch.as_tensor(wgt))
    (out1 ** 2).sum().backward()

    lines = []
    for name, fn, part in (("ring", ring.ring_spmm, rp),
                           ("allgather", ring.allgather_spmm, gp)):
        hl = h[rows].clone().requires_grad_(True)
        args = [torch.as_tensor(a[me]) for a in (part.senders,
                                                 part.receivers,
                                                 part.weights)]
        with comm.recording() as ledger:
            out = fn(hl, *args, group=group)
        err = float((out.detach() - ref[rows]).abs().max())
        assert err < 1e-4, (name, err)
        total = comm.all_reduce((out ** 2).sum(), group)
        total.backward()
        gerr = float((hl.grad - h1.grad[rows]).abs().max()
                     / (h1.grad.abs().max() + 1e-9))
        assert gerr < GRAD_TOL, (name, "grad", gerr)
        model = (comm_model.ring_spmm_traffic if name == "ring"
                 else comm_model.spmm_feature_allgather)(N, F, n,
                                                         dtype_bytes=4)
        rec = validate_traffic(f"spmm_{name}", model, ledger)
        assert rec.measured_bytes == rec.analytical_bytes, rec
        lines.append(f"{name}: max abs err {err:.3e}, grad rel err "
                     f"{gerr:.3e}; # ledger {rec}")
    return lines


def check_gpipe(rank: int, world: int, data: dict) -> list[str]:
    """GPipe over the 4-stage ``pipe`` axis of a (2, 4) mesh: outputs
    against the reference's, gradients against single-device autograd."""
    from repro_torch.distributed import comm
    from repro_torch.distributed.pipeline_par import gpipe_apply

    policy = _policy((2, 4), ("data", "pipe"))
    group = policy.group("pipe")
    r = comm.group_rank(group)
    ws, bs = torch.as_tensor(data["ws"]), torch.as_tensor(data["bs"])
    x = torch.as_tensor(data["x"])

    def stage(p, h):
        w, b = p
        return torch.tanh(h @ w + b)

    w = ws[r].clone().requires_grad_(True)
    b = bs[r].clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    out = gpipe_apply(stage, (w, b), xr, group=group)
    err = _rel(out.detach().numpy(), data["expect"])
    assert err < 1e-5, ("gpipe", err)
    (out ** 2).sum().backward()
    # The input is replicated: its gradient is the ranks' parts summed.
    xg = comm.all_reduce(xr.grad, group)

    ws1, bs1 = ws.clone().requires_grad_(True), bs.clone().requires_grad_(True)
    x1 = x.clone().requires_grad_(True)
    ref = x1
    for s in range(ws.shape[0]):
        ref = torch.tanh(ref @ ws1[s] + bs1[s])
    (ref ** 2).sum().backward()
    gerr = max(_rel(w.grad.numpy(), ws1.grad[r].numpy()),
               _rel(b.grad.numpy(), bs1.grad[r].numpy()),
               _rel(xg.numpy(), x1.grad.numpy()))
    assert gerr < GRAD_TOL, ("gpipe grad", gerr)
    return [f"gpipe: rel err {err:.3e}, grad rel err {gerr:.3e}"]


def check_dlrm(rank: int, world: int, data: dict) -> list[str]:
    """DLRM vocab-parallel: tables sharded over all axes, over tp alone
    and replicated, logits against the reference's."""
    from repro_torch import params
    from repro_torch.core import comm_model
    from repro_torch.distributed import comm
    from repro_torch.models import dlrm

    policy = _policy()
    lines = []
    for case in data["cases"]:
        cfg = case["cfg"]
        model = params.shard_dlrm(case["params"], cfg, policy, device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
        with comm.recording() as ledger:
            local = dlrm.forward(cfg, model, batch, policy=policy)
        got = comm.all_gather(local, policy.group(policy.all_axes), 0)
        err = _rel(got.numpy(), case["expect"])
        assert err < REL_TOL, ("dlrm", cfg.vocab_sizes[:4], err)
        kinds = sorted(set(model.shards))
        modelled = comm_model.dlrm_embedding_exchange(
            batch["dense"].shape[0] // policy.n_devices, cfg.n_sparse,
            cfg.embed_dim, policy.n_devices, with_backward=False)
        lines.append(f"dlrm {cfg.vocab_sizes[:4]} shards {kinds}: rel err "
                     f"{err:.3e}; # ledger all-reduce "
                     f"{ledger.total_wire_bytes_per_chip:.0f} B a rank vs "
                     f"dlrm_embedding_exchange (fwd) "
                     f"{modelled.total('ici'):.0f} B")
    return lines


def check_dlrm_draw(rank: int, world: int, data: dict) -> list[str]:
    """DLRM drawn in place (``source=None``): a replicated table and the
    MLPs are the same on every rank, a table sharded over tp alone the same
    on the ranks that share its tp index, and distinct shards differ."""
    import torch.distributed as dist

    from repro_torch import params
    from repro_torch.distributed import comm

    policy = _policy()
    everyone = policy.group(policy.all_axes)
    cfg = data["cfg"]
    model = params.shard_dlrm(None, cfg, policy, device="cpu", seed=3)
    me = comm.group_rank(everyone)
    tp_of = torch.tensor([policy.coord(policy.tp_axis)])
    tps = comm.all_gather(tp_of, everyone, 0).tolist()
    kinds = {}
    for t, (table, shards) in enumerate(zip(model.tables, model.shards)):
        every = comm.all_gather(table[None], everyone, 0)
        for r in range(world):
            same = bool(torch.equal(every[r], table))
            expect = (shards == 1 or (shards < world and tps[r] == tps[me])
                      or r == me)
            assert same == expect, (t, shards, rank, r, same)
        kinds[shards] = kinds.get(shards, 0) + 1
    for mlp in (model.bot, model.top):
        for a in mlp["w"] + mlp["b"]:
            every = comm.all_gather(a[None], everyone, 0)
            assert all(torch.equal(e, a) for e in every)
    dist.barrier(group=everyone)
    return [f"dlrm draw: tables by shard count {sorted(kinds.items())} "
            "agree wherever a shard repeats"]


def check_traffic(rank: int, world: int, data: dict) -> list[str]:
    """The ledger against the analytical models, exactly: the DP gradient
    all-reduce and the all-gather SpMM's feature collection over 8 ranks."""
    from repro_torch.core import comm_model
    from repro_torch.core.validation import validate_traffic
    from repro_torch.distributed import comm, ring

    policy = _policy((8,), ("data",))
    group = policy.group("data")
    me = comm.group_rank(group)
    D, F = 128, 64
    w = torch.zeros((D, F), requires_grad=True)
    x = torch.zeros((256, D))[me * 32:(me + 1) * 32]
    with comm.recording() as ledger:
        ((x @ w) ** 2).sum().backward()
        comm.all_reduce_grads([w.grad], group)
    rec = validate_traffic("dp_allreduce",
                           comm_model.dp_gradient_sync(D * F * 4, 8), ledger)
    assert rec.measured_bytes == rec.analytical_bytes, rec

    rng = np.random.default_rng(0)
    N, E, Fq = 64, 256, 16
    snd, rcv = rng.integers(0, N, E), rng.integers(0, N, E)
    wgt = rng.random(E).astype(np.float32)
    gp = ring.partition_edges_gather(snd, rcv, wgt, N, 8)
    with comm.recording() as ledger2:
        ring.allgather_spmm(torch.zeros((N // 8, Fq)),
                            torch.as_tensor(gp.senders[me]),
                            torch.as_tensor(gp.receivers[me]),
                            torch.as_tensor(gp.weights[me]), group=group)
    rec2 = validate_traffic("spmm_allgather",
                            comm_model.spmm_feature_allgather(N, Fq, 8),
                            ledger2)
    assert rec2.measured_bytes == rec2.analytical_bytes, rec2
    return [f"# ledger {rec}", f"# ledger {rec2}"]


CHECKS = {name[len("check_"):]: fn for name, fn in globals().items()
          if name.startswith("check_")}


def rank_main(rank: int, world: int, check: str, path: str) -> list[str]:
    with open(path, "rb") as f:
        data = pickle.load(f)
    return CHECKS[check](rank, world, data)


def main(argv: list[str]) -> int:
    from repro_torch.launch.mesh import spawn

    check, path = argv
    results = spawn(rank_main, 8, backend="gloo", args=(check, path))
    for line in results[0]:
        print(line)
    print(f"CHECK {check} PASSED on {len(results)} ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
