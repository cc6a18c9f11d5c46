"""Real spherical-harmonic rotation (Wigner) matrices, NumPy on the host (a
copy of the reference's ``repro/data/wigner.py``).

EquiformerV2's eSCN convolution rotates each edge's irrep features so the
edge vector aligns with +z, applies an SO(2)-block linear map and rotates
back.  The per-edge rotation matrices are data: the pipeline makes them on
the host and ships them to the device as ordinary arrays.

The recursion is Ivanic & Ruedenberg's (J. Phys. Chem. 1996, 1998
erratum): the real-SH rotation matrix R^l comes from R^1 and R^{l-1} through
the u, v, w coefficient tables.  Conventions: real SH ordered m = -l..l;
R^1 acts on (Y_1^{-1}, Y_1^0, Y_1^1) ~ (y, z, x).

Here the recursion runs over a batch of rotations at once, each entry an
array operation over the batch in the reference's order of operations, so
:func:`wigner_stack` gives the reference's per-edge loop's values bit for
bit at a fraction of its host time.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["wigner_d_real", "wigner_stack", "rotation_to_z", "random_rotation"]

#: Row and column order of the l = 1 real-SH basis, (y, z, x), in Cartesian
#: indices: R^1[i, j] = R[_YZX[i], _YZX[j]].
_YZX = np.array([1, 2, 0])


def _uvw(l: int, mu: int, m_: int) -> tuple[float, float, float]:
    d = 1.0 if mu == 0 else 0.0
    if abs(m_) < l:
        denom = (l + m_) * (l - m_)
    else:
        denom = (2 * l) * (2 * l - 1)
    u = math.sqrt((l + mu) * (l - mu) / denom)
    v = 0.5 * math.sqrt((1 + d) * (l + abs(mu) - 1) * (l + abs(mu)) / denom) * (1 - 2 * d)
    w = -0.5 * math.sqrt((l - abs(mu) - 1) * (l - abs(mu)) / denom) * (1 - d)
    return u, v, w


def _P(i: int, l: int, mu: int, m_: int, r1: np.ndarray,
       rlm1: np.ndarray) -> np.ndarray:
    """The recursion's helper P_i^{mu,m} (Ivanic & Ruedenberg, Table 1) for
    every rotation of the batch: ``r1`` is (B, 3, 3), ``rlm1`` (B, 2l-1,
    2l-1)."""
    def ri(a, b):
        return r1[:, a + 1, b + 1]

    def rl(a, b):
        return rlm1[:, a + l - 1, b + l - 1]

    if m_ == l:
        return ri(i, 1) * rl(mu, l - 1) - ri(i, -1) * rl(mu, -(l - 1))
    if m_ == -l:
        return ri(i, 1) * rl(mu, -(l - 1)) + ri(i, -1) * rl(mu, l - 1)
    return ri(i, 0) * rl(mu, m_)


def _wigner_next(l: int, r1: np.ndarray, rlm1: np.ndarray) -> np.ndarray:
    """R^l of every rotation of the batch from R^1 and R^{l-1}."""
    size = 2 * l + 1
    out = np.zeros((r1.shape[0], size, size), dtype=np.float64)
    for mu in range(-l, l + 1):
        for m_ in range(-l, l + 1):
            u, v, w = _uvw(l, mu, m_)
            val = 0.0
            if u:
                val += u * _P(0, l, mu, m_, r1, rlm1)
            if v:
                if mu == 0:
                    val += v * (_P(1, l, 1, m_, r1, rlm1)
                                + _P(-1, l, -1, m_, r1, rlm1))
                elif mu > 0:
                    val += v * (_P(1, l, mu - 1, m_, r1, rlm1)
                                * math.sqrt(1 + (1.0 if mu == 1 else 0.0))
                                - _P(-1, l, -mu + 1, m_, r1, rlm1)
                                * (0.0 if mu == 1 else 1.0))
                else:
                    val += v * (_P(1, l, mu + 1, m_, r1, rlm1)
                                * (0.0 if mu == -1 else 1.0)
                                + _P(-1, l, -mu - 1, m_, r1, rlm1)
                                * math.sqrt(1 + (1.0 if mu == -1 else 0.0)))
            if w:
                if mu > 0:
                    val += w * (_P(1, l, mu + 1, m_, r1, rlm1)
                                + _P(-1, l, -mu - 1, m_, r1, rlm1))
                elif mu < 0:
                    val += w * (_P(1, l, mu - 1, m_, r1, rlm1)
                                - _P(-1, l, -mu + 1, m_, r1, rlm1))
            out[:, mu + l, m_ + l] = val
    return out


def _wigner_batch(Rs: np.ndarray, l_max: int) -> list[np.ndarray]:
    """[R^0 .. R^{l_max}], each (B, 2l+1, 2l+1), for B Cartesian rotations."""
    Rs = np.asarray(Rs, np.float64)
    mats = [np.ones((Rs.shape[0], 1, 1), dtype=np.float64)]
    if l_max >= 1:
        mats.append(np.ascontiguousarray(Rs[:, _YZX][:, :, _YZX]))
    for l in range(2, l_max + 1):
        mats.append(_wigner_next(l, mats[1], mats[-1]))
    return mats


def wigner_d_real(R: np.ndarray, l_max: int) -> list[np.ndarray]:
    """Real-SH rotation matrices [R^0 .. R^{l_max}] for Cartesian rotation R."""
    return [m[0] for m in _wigner_batch(np.asarray(R)[None], l_max)]


def wigner_stack(Rs: np.ndarray, l_max: int, *, m_max: int | None = None,
                 dtype=np.float32) -> dict[int, np.ndarray]:
    """Per-edge rotation blocks {l: (E, m_dim, 2l+1)}.

    With eSCN's m_max restriction only the rows |m| <= m_max are kept (the
    SO(2) conv never reads the others).  Rows are always reordered to
    (m=0, m=1c, m=1s, ..., c, s): real-SH index l+m supplies the 'cos' row
    and l-m the 'sin' row, the layout
    :func:`repro_torch.models.gnn.equiformer_v2._so2_conv` consumes.
    """
    mats = _wigner_batch(Rs, l_max)
    out: dict[int, np.ndarray] = {}
    for l in range(l_max + 1):
        m_keep = l if m_max is None else min(l, m_max)
        rows = [l]  # m = 0 row index in (-l..l) offset l
        for m in range(1, m_keep + 1):
            rows.extend([l + m, l - m])
        out[l] = mats[l][:, rows, :].astype(dtype)
    return out


def rotation_to_z(vec: np.ndarray) -> np.ndarray:
    """Rotation matrix taking ``vec`` (3,) to +z (Rodrigues)."""
    v = np.asarray(vec, np.float64)
    n = np.linalg.norm(v)
    if n < 1e-12:
        return np.eye(3)
    v = v / n
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(v, z)
    s = np.linalg.norm(axis)
    c = float(v @ z)
    if s < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    axis = axis / s
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform random rotation via QR of a Gaussian matrix."""
    A = rng.standard_normal((3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q @ np.diag(np.sign(np.diag(R)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q
