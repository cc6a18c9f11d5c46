"""Power-law degrees of exponent ``graph["degree_exponent"]`` (P(k) ~
k^-gamma): each pair's receiver is drawn from rank weights
r^(-1/(gamma-1)) over a seeded permutation of the nodes, and its sender
apart from it, from the same law over another permutation, so a node's
two ends are not tied and no node is both sides' hub.  A pair whose two
ends meet is moved to the next sender (no self-loop among the pairs)."""

from __future__ import annotations

import torch

#: Pairs drawn a call (bounds the float64 uniforms in flight).
DRAW_CHUNK = 1 << 25


def _rank_cdf(n: int, gamma: float, device) -> torch.Tensor:
    alpha = 1.0 / (gamma - 1.0)
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** -alpha
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


def _draw(cdf: torch.Tensor, count: int, gen: torch.Generator
          ) -> torch.Tensor:
    """``count`` ranks drawn from the weights whose CDF is ``cdf``."""
    out = torch.empty(count, dtype=torch.int64, device=cdf.device)
    for lo in range(0, count, DRAW_CHUNK):
        hi = min(lo + DRAW_CHUNK, count)
        u = torch.rand(hi - lo, dtype=torch.float64, generator=gen,
                       device=cdf.device)
        out[lo:hi] = torch.searchsorted(cdf, u, right=True).clamp_(
            max=cdf.numel() - 1)
    return out


def pairs(graph: dict, count: int, gen: torch.Generator
          ) -> tuple[torch.Tensor, torch.Tensor]:
    n = graph["n_nodes"]
    device = gen.device
    cdf = _rank_cdf(n, graph["degree_exponent"], device)
    perm_r = torch.randperm(n, generator=gen, device=device)
    perm_s = torch.randperm(n, generator=gen, device=device)
    receivers = perm_r[_draw(cdf, count, gen)]
    senders = perm_s[_draw(cdf, count, gen)]
    same = senders == receivers
    senders[same] = (senders[same] + 1) % n
    return senders, receivers
