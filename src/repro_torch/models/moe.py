"""Mixture-of-Experts configuration (the reference's ``models/moe.py``).

Only :class:`MoEConfig` is ported, so that the MoE architectures
(qwen3-moe-30b-a3b, arctic-480b) construct, count their parameters and
join the workload bridges.  The MoE layer itself (routing, capacity
dispatch, expert parallelism) is not ported yet: building a
:class:`~repro_torch.models.transformer.Transformer` from an MoE config
raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["MoEConfig"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # Snowflake-Arctic-style dense residual MLP running in parallel with the
    # experts (d_ff of that branch); None disables it.
    dense_residual_d_ff: Optional[int] = None
    aux_loss_weight: float = 0.01
