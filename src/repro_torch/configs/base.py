"""Input-shape cells of the LM and recsys families (the reference's
``configs/base.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

__all__ = ["ShapeSpec", "LM_SHAPES", "RECSYS_SHAPES"]


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell."""

    name: str
    kind: str                      # train | prefill | decode | serve | retrieval
    params: Mapping[str, Any]


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            {"seq": 32768, "batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode",
                           {"seq": 524288, "batch": 1}),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                {"batch": 1, "n_candidates": 1000000}),
}
