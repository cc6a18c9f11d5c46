"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings of the checked steps (the first two or
three) from the same weights on the same batches (:func:`gpubench.
reference.common.adamw_steps`): each step's loss, each leaf's norm of the
first gradient as the optimizer takes it (clipped) and its norm, and each
leaf's norm of the parameters' change after the last checked step.  Four
numbers are read, each against its own limit:

* ``loss_step1``: the relative gap of the first step's loss.  The later
  steps' losses are printed but not held: AdamW's first update is about
  ``lr`` times the sign of each gradient entry, so entries whose gradient
  is rounding flip between float32 and float64 and move the next loss by
  what the seed happens to give (EquiformerV2's second loss: 1.4e-06 to
  1.1e-04 on sound runs against the first's 2e-08 to 7.7e-06); ``delta``
  holds the state after them;
* ``grad``: over the leaves, the largest gap between the two first
  gradients' norms, relative to the reference's norm of that leaf or of
  the median leaf, whichever is larger;
* ``delta``: the same of the change after the checked steps, over the leaves
  whose reference first gradient passes :data:`ZERO_SHARE` of the median
  leaf's (below it a leaf's gradient is rounding, which AdamW turns into
  a full step either way);
* ``grad_diff``: over the leaves, the largest norm of the difference of
  the two first gradients, relative as ``grad`` is.  A gap of norms
  cancels rounding that is random in sign (TF32's on GCN's two small
  transforms reads like float32's there); the difference does not.

A cell holds the numbers that its limits name (``workloads/<cell>.json``).
"""

from __future__ import annotations

import math
import statistics

import torch

#: A leaf whose reference first gradient is under this share of the
#: median leaf's is left out of ``delta``.
ZERO_SHARE = 1e-3


def _gap(prog: dict, ref: dict, keys, scale: dict | None = None
         ) -> tuple[float, str]:
    """The worst leaf of ``keys``: ``|prog - ref|`` over the larger of the
    leaf's and the median leaf's ``scale`` (``ref`` by default)."""
    scale = ref if scale is None else scale
    median = statistics.median(scale.values())
    worst, where = 0.0, ""
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(scale[k], median, 1e-300)
        if not math.isfinite(gap):
            return math.inf, k
        if gap >= worst:
            worst, where = gap, k
    return worst, where


def compare(prog: dict, ref: dict) -> dict:
    """``{name: (value, where)}`` of the four numbers."""
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the two sides' leaves differ: "
                         f"{sorted(set(prog['grad']) ^ set(ref['grad']))}")
    loss = abs(prog["loss"][0] - ref["loss"][0]) / max(abs(ref["loss"][0]),
                                                        1e-300)
    if not all(math.isfinite(x) for x in prog["loss"] + [loss]):
        loss = math.inf
    median = statistics.median(ref["grad"].values())
    kept = [k for k, v in ref["grad"].items() if v >= ZERO_SHARE * median]
    diff = {k: float(torch.linalg.vector_norm(
        prog["grad_t"][k].double() - ref["grad_t"][k].double()))
        for k in ref["grad"]}
    return {"loss_step1": (loss, "step 1"),
            "grad": _gap(prog["grad"], ref["grad"], ref["grad"]),
            "delta": _gap(prog["delta"], ref["delta"], kept),
            "grad_diff": _gap(diff, dict.fromkeys(diff, 0.0), ref["grad"],
                              scale=ref["grad"])}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number that ``limits`` names finite and within its limit."""
    if not set(limits) <= set(numbers):
        raise ValueError(f"limits {sorted(limits)} against numbers "
                         f"{sorted(numbers)}")
    return all(math.isfinite(numbers[k][0]) and numbers[k][0] <= limit
               for k, limit in limits.items())
