"""Real spherical-harmonic rotation (Wigner) blocks of a batch of edge
vectors, in PyTorch on any device.

The rotation takes each edge vector to +z (Rodrigues' formula; a vector
along -z turns about x; a zero vector keeps the identity), and its
real-SH matrices R^l come from R^1 and R^{l-1} by Ivanic and
Ruedenberg's recursion (J. Phys. Chem. 1996, 1998 erratum), real SH
ordered m = -l..l, R^1 acting on (y, z, x).  eSCN keeps the rows
|m| <= m_max, ordered (m=0, 1c, 1s, 2c, 2s, ...): index l + m gives the
cos row and l - m the sin row.
"""

from __future__ import annotations

import math

import torch

_YZX = [1, 2, 0]


def rotation_to_z(vec: torch.Tensor) -> torch.Tensor:
    """(E, 3, 3) rotations taking each row of ``vec`` (E, 3) to +z."""
    n = torch.linalg.vector_norm(vec, dim=1, keepdim=True)
    v = vec / n.clamp_min(1e-300)
    zero = n[:, 0] < 1e-12
    axis = torch.stack([v[:, 1], -v[:, 0], torch.zeros_like(v[:, 0])], 1)
    s = torch.linalg.vector_norm(axis, dim=1)
    c = v[:, 2]
    axis = axis / s.clamp_min(1e-300)[:, None]
    K = torch.zeros(vec.shape[0], 3, 3, dtype=vec.dtype, device=vec.device)
    K[:, 0, 1], K[:, 0, 2] = -axis[:, 2], axis[:, 1]
    K[:, 1, 0], K[:, 1, 2] = axis[:, 2], -axis[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -axis[:, 1], axis[:, 0]
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device).expand_as(K)
    R = eye + s[:, None, None] * K + (1 - c)[:, None, None] * (K @ K)
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=vec.dtype,
                                   device=vec.device)).expand_as(K)
    along = (s < 1e-12)[:, None, None]
    R = torch.where(along, torch.where((c > 0)[:, None, None], eye, flip), R)
    return torch.where(zero[:, None, None], eye, R)


def _uvw(l: int, mu: int, m_: int) -> tuple[float, float, float]:
    d = 1.0 if mu == 0 else 0.0
    denom = (l + m_) * (l - m_) if abs(m_) < l else (2 * l) * (2 * l - 1)
    u = math.sqrt((l + mu) * (l - mu) / denom)
    v = 0.5 * math.sqrt((1 + d) * (l + abs(mu) - 1) * (l + abs(mu))
                        / denom) * (1 - 2 * d)
    w = -0.5 * math.sqrt((l - abs(mu) - 1) * (l - abs(mu)) / denom) * (1 - d)
    return u, v, w


def _P(i: int, l: int, mu: int, m_: int, r1, rl1):
    def ri(a, b):
        return r1[:, a + 1, b + 1]

    def rl(a, b):
        return rl1[:, a + l - 1, b + l - 1]

    if m_ == l:
        return ri(i, 1) * rl(mu, l - 1) - ri(i, -1) * rl(mu, -(l - 1))
    if m_ == -l:
        return ri(i, 1) * rl(mu, -(l - 1)) + ri(i, -1) * rl(mu, l - 1)
    return ri(i, 0) * rl(mu, m_)


def _next(l: int, r1, rl1):
    out = r1.new_zeros((r1.shape[0], 2 * l + 1, 2 * l + 1))
    for mu in range(-l, l + 1):
        for m_ in range(-l, l + 1):
            u, v, w = _uvw(l, mu, m_)
            val = torch.zeros_like(r1[:, 0, 0])
            if u:
                val = val + u * _P(0, l, mu, m_, r1, rl1)
            if v:
                if mu == 0:
                    val = val + v * (_P(1, l, 1, m_, r1, rl1)
                                     + _P(-1, l, -1, m_, r1, rl1))
                elif mu > 0:
                    val = val + v * (
                        _P(1, l, mu - 1, m_, r1, rl1)
                        * math.sqrt(2.0 if mu == 1 else 1.0)
                        - _P(-1, l, -mu + 1, m_, r1, rl1)
                        * (0.0 if mu == 1 else 1.0))
                else:
                    val = val + v * (
                        _P(1, l, mu + 1, m_, r1, rl1)
                        * (0.0 if mu == -1 else 1.0)
                        + _P(-1, l, -mu - 1, m_, r1, rl1)
                        * math.sqrt(2.0 if mu == -1 else 1.0))
            if w:
                if mu > 0:
                    val = val + w * (_P(1, l, mu + 1, m_, r1, rl1)
                                     + _P(-1, l, -mu - 1, m_, r1, rl1))
                elif mu < 0:
                    val = val + w * (_P(1, l, mu - 1, m_, r1, rl1)
                                     - _P(-1, l, -mu + 1, m_, r1, rl1))
            out[:, mu + l, m_ + l] = val
    return out


def blocks(vec: torch.Tensor, l_max: int, m_max: int) -> dict:
    """``{l: (E, m_dim, 2l+1)}``: each edge's rotation blocks, the rows
    |m| <= m_max in (m=0, 1c, 1s, ...) order, in ``vec``'s dtype."""
    R = rotation_to_z(vec)
    mats = [R.new_ones((R.shape[0], 1, 1))]
    if l_max >= 1:
        mats.append(R[:, _YZX][:, :, _YZX].contiguous())
    for l in range(2, l_max + 1):
        mats.append(_next(l, mats[1], mats[-1]))
    out = {}
    for l in range(l_max + 1):
        rows = [l]
        for m in range(1, min(l, m_max) + 1):
            rows += [l + m, l - m]
        out[l] = mats[l][:, rows, :]
    return out
