"""The reference's train steps under a sharding policy, on 8 fake CPU
devices.

NOT collected by pytest (its name has no ``test_`` prefix): the device
count must be forced before jax initializes, as ``tests/
distributed_checks.py`` does.  ``tests/test_torch_policy_train.py`` writes
the inputs (the reference's ``init_params`` as numpy, the batches and the
cases) into a pickle and runs

    python tests/torch_policy_train_ref.py JOB IN_PICKLE OUT_PICKLE

JOB ``lm``: for each case (a smoke config, a mesh, the CE path), three
steps of ``transformer.make_train_step(cfg, adamw(3e-4, weight_decay=0.1),
policy=make_policy(mesh))``.  JOB ``dlrm``: three steps of the reference's
``_dlrm_plan`` train step (``value_and_grad`` of ``dlrm.loss_fn(policy=)``,
then ``adamw(1e-3)``) on the (2, 4) mesh.  Each writes every step's loss,
the first step's moments and the last step's parameters and moments as
numpy.  The sequence-chunked CE path is forced by lowering the module's
``_CE_CHUNK_THRESHOLD`` (and ``_CE_CHUNK``) at run time.
"""

from __future__ import annotations

import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.distributed.sharding import make_policy  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import dlrm as dlrm_lib  # noqa: E402
from repro.models import transformer as tf  # noqa: E402
from repro.optim.optimizers import adamw, apply_updates  # noqa: E402

_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _state(params, opt_state) -> dict:
    return {"params": _NP(params), "mu": _NP(opt_state.mu),
            "nu": _NP(opt_state.nu)}


def run_lm(data: dict) -> dict:
    out = {}
    defaults = (tf._CE_CHUNK_THRESHOLD, tf._CE_CHUNK)
    for case in data["cases"]:
        name, shape, chunked = case
        cfg = get_arch(name).make_smoke_config()
        tf._CE_CHUNK_THRESHOLD, tf._CE_CHUNK = (
            data["chunking"] if chunked else defaults)
        policy = make_policy(make_test_mesh(shape))
        opt = adamw(3e-4, weight_decay=0.1)
        step = jax.jit(tf.make_train_step(cfg, opt, policy=policy))
        params = jax.tree_util.tree_map(jnp.asarray, data["params"][name])
        batch = {k: jnp.asarray(v) for k, v in data["batch"][name].items()}
        state = opt.init(params)
        losses, first_mu = [], None
        for _ in range(data["steps"]):
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
            if first_mu is None:
                first_mu = _NP(state.mu)
        out[case] = {"losses": losses, "first_mu": first_mu,
                     **_state(params, state)}
    tf._CE_CHUNK_THRESHOLD, tf._CE_CHUNK = defaults
    return out


def run_dlrm(data: dict) -> dict:
    cfg = data["cfg"]
    policy = make_policy(make_test_mesh(data["shape"]))
    opt = adamw(1e-3)

    def train_step(params, opt_state, batch):
        (_, metrics), grads = jax.value_and_grad(
            lambda q: dlrm_lib.loss_fn(cfg, q, batch, policy=policy),
            has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, metrics

    step = jax.jit(train_step)
    params = jax.tree_util.tree_map(jnp.asarray, data["params"])
    batch = {k: jnp.asarray(v) for k, v in data["batch"].items()}
    state = opt.init(params)
    losses, first_mu = [], None
    for _ in range(data["steps"]):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        if first_mu is None:
            first_mu = _NP(state.mu)
    return {"losses": losses, "first_mu": first_mu, **_state(params, state)}


def main(argv: list[str]) -> int:
    job, src, dst = argv
    with open(src, "rb") as f:
        data = pickle.load(f)
    out = {"lm": run_lm, "dlrm": run_dlrm}[job](data)
    with open(dst, "wb") as f:
        pickle.dump(out, f)
    print(f"REFERENCE {job} DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
