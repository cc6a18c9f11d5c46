"""Sharding policy: the one place that knows the mesh axes.

A :class:`ShardingPolicy` binds a mesh and its role split: which axes carry
data parallelism and which carries model parallelism (TP heads and FFN, EP
experts and SP sequence all ride the ``model`` axis; the optional ``pod``
axis extends data parallelism across pods).  It is the reference's
``distributed/sharding.py`` over ``torch.distributed``: the sizes and the
spec helpers are the same, and a spec is a tuple whose entries equal the
reference's ``PartitionSpec`` entries (an axis name, a tuple of axis names,
or ``None``).

The reference hands specs to GSPMD, which inserts the collectives.  Here
each rank runs its own program, so the policy also answers the two
questions that program asks: :meth:`ShardingPolicy.group`, the process
group over some axes, and :meth:`ShardingPolicy.coord`, this rank's flat
index along them (row-major, as the reference's ``_flat_rank``).  Over an
:class:`repro_torch.launch.mesh.AbstractMesh` only the spec helpers work.

``policy=None`` everywhere means single-device execution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Union

from ..launch.mesh import AbstractMesh, axis_sizes

__all__ = ["ShardingPolicy", "make_policy", "fsdp_specs", "shard_slices",
           "spec_axes", "sharded_global_norm"]

Axes = Union[str, tuple]


def _axes(axes: Axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclass(frozen=True)
class ShardingPolicy:
    """Axis roles over a mesh.

    dp_axes: axes that shard the batch (("pod", "data") or ("data",)).
    tp_axis: the model-parallel axis (TP heads/ffn, EP experts, SP
    sequence).
    """

    mesh: Any
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    seq_parallel_residual: bool = True     # residual stream sharded over tp
    _groups: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if isinstance(self.mesh, AbstractMesh):
            return
        import torch.distributed as dist

        # Every rank builds every multi-axis group, in the same order.  The
        # axes within a pod carry a long-context decode cache.
        names = tuple(self.mesh.mesh_dim_names)
        in_pod = tuple(a for a in names if a != "pod")
        for axes in (tuple(self.dp_axes), self.all_axes, names, in_pod):
            axes = tuple(dict.fromkeys(axes))
            if len(axes) > 1 and axes not in self._groups:
                groups = self._rank_lists(axes)
                mine, _ = dist.new_subgroups_by_enumeration(groups)
                self._groups[axes] = mine

    def _rank_lists(self, axes: tuple[str, ...]) -> list[list[int]]:
        names = list(self.mesh.mesh_dim_names)
        order = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in order]
        t = self.mesh.mesh.permute(*rest, *order)
        return t.reshape(-1, self.size(axes)).tolist()

    # ---- sizes -----------------------------------------------------------
    @property
    def axis_sizes(self) -> dict[str, int]:
        return axis_sizes(self.mesh)

    def size(self, axes: Axes) -> int:
        out = 1
        for a in _axes(axes):
            out *= self.axis_sizes[a]
        return out

    @property
    def dp(self) -> int:
        return self.size(self.dp_axes)

    @property
    def tp(self) -> int:
        return self.axis_sizes[self.tp_axis]

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.dp_axes) + (self.tp_axis,)

    # ---- spec helpers ----------------------------------------------------
    @property
    def dp_spec(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def act_spec(self) -> tuple:
        """Residual-stream activations (B, S, d)."""
        if self.seq_parallel_residual:
            return (self.dp_spec, self.tp_axis, None)
        return (self.dp_spec, None, None)

    def batch_spec(self) -> tuple:
        return (self.dp_spec, None)

    # ---- this rank's view ------------------------------------------------
    def group(self, axes: Axes):
        """The process group of the ranks that differ from this one only
        along ``axes``."""
        axes = tuple(dict.fromkeys(_axes(axes)))
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        if axes not in self._groups:
            raise KeyError(f"no group over {axes}; the policy builds "
                           f"{sorted(self._groups)} and each single axis")
        return self._groups[axes]

    def coord(self, axes: Axes) -> int:
        """This rank's flat index along ``axes``, the first outermost."""
        r = 0
        for a in dict.fromkeys(_axes(axes)):
            r = r * self.axis_sizes[a] + self.mesh.get_local_rank(a)
        return r


def make_policy(mesh, **kw) -> ShardingPolicy:
    names = tuple(mesh.axis_names if isinstance(mesh, AbstractMesh)
                  else mesh.mesh_dim_names)
    dp_axes = tuple(a for a in names if a in ("pod", "data")) or names[:1]
    tp_axis = "model" if "model" in names else names[-1]
    return ShardingPolicy(mesh=mesh, dp_axes=dp_axes, tp_axis=tp_axis, **kw)


def _itemsize(dtype) -> int:
    return dtype.itemsize


def _tree_map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_tree_map2(fn, a, s) for a, s in zip(tree, specs)]
    return fn(tree, specs)


def fsdp_specs(abstract_params, base_specs, policy: ShardingPolicy,
               *, min_bytes: int = 1 << 20):
    """ZeRO-3/FSDP: additionally shard every large parameter leaf over the
    dp axes.

    For each leaf >= ``min_bytes`` the largest dimension not already
    sharded and divisible by dp picks up the dp axes.  Leaves are anything
    with ``shape`` and ``dtype`` (meta tensors, numpy arrays).
    """
    dp = policy.dp
    dp_axes = policy.dp_spec

    def one(leaf, spec: tuple) -> tuple:
        shape = tuple(leaf.shape)
        size = 1
        for s in shape:
            size *= s
        if size * _itemsize(leaf.dtype) < min_bytes or dp <= 1:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        best, best_dim = -1, -1
        for d, (n, cur) in enumerate(zip(shape, entries)):
            if cur is None and n % dp == 0 and n > best:
                best, best_dim = n, d
        if best_dim < 0:
            return spec
        entries[best_dim] = dp_axes
        return tuple(entries)

    return _tree_map2(one, abstract_params, base_specs)


def shard_slices(shape, spec: tuple, policy: ShardingPolicy) -> tuple:
    """The index (a tuple of slices) of this rank's block of a tensor of
    ``shape`` laid out by ``spec``: each dim whose entry names axes splits
    evenly over their ranks (it must divide), at :meth:`ShardingPolicy.
    coord`."""
    index = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            index.append(slice(None))
            continue
        parts = policy.size(entry)
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{parts} ways ({entry})")
        step = n // parts
        lo = policy.coord(entry) * step
        index.append(slice(lo, lo + step))
    return tuple(index)


def spec_axes(spec: tuple, policy: ShardingPolicy) -> tuple[str, ...]:
    """The mesh axes a leaf laid out by ``spec`` is split over, in the
    order of ``policy.all_axes`` (empty for a replicated leaf)."""
    named = set()
    for entry in spec:
        if entry is not None:
            named.update(_axes(entry))
    return tuple(a for a in policy.all_axes if a in named)


def sharded_global_norm(tree, specs, policy: ShardingPolicy):
    """The global norm of a tree of this rank's blocks (``specs`` its
    layout): each leaf's f32 squares summed locally, the sums of the
    leaves split over the same axes summed over those axes' group (one
    all-reduce per set of axes, tagged ``"grad_norm"``), a replicated
    leaf counted once.  Every rank gets the same value, the norm of the
    whole gradient, so clipping scales every shard alike."""
    import torch

    from ..tree import is_spec, tree_leaves
    from . import comm

    parts: dict[tuple, object] = {}
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs, is_spec)):
        sq = torch.sum(torch.square(leaf.float()))
        axes = spec_axes(spec, policy)
        parts[axes] = sq if axes not in parts else parts[axes] + sq
    total = None
    for axes, sq in parts.items():
        if axes:
            sq = comm.all_reduce(sq, policy.group(axes), tag="grad_norm")
        total = sq if total is None else total + sq
    return torch.sqrt(total)
