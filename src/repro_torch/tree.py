"""Trees of tensors in the reference's pytree order, and their gradients.

The reference keeps parameters and optimizer states as JAX pytrees, and its
checkpoints and global norms walk their leaves in
``jax.tree_util.tree_flatten``'s order: a dict's values by sorted key, a
list's or tuple's in order, a NamedTuple's by field, ``None`` as an empty
node.  These functions walk nested dicts, lists, tuples and NamedTuples in
that same order, so a port state flattens to the reference's leaves one for
one (``torch.utils._pytree`` keeps a dict's insertion order instead).
Anything else is a leaf, and so is any node that ``is_leaf`` accepts (for
trees of shapes or sharding specs, :func:`is_spec`: a plain tuple).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

__all__ = ["TreeDef", "tree_flatten", "tree_unflatten", "tree_leaves",
           "tree_map", "tree_paths", "is_spec", "value_and_grad"]


class TreeDef(NamedTuple):
    """One node: ``kind`` ("leaf", "none", "dict", "list", "tuple" or a
    NamedTuple class), the sorted dict keys, and the children's defs."""

    kind: Any
    keys: tuple = ()
    children: tuple = ()

    def __repr__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c!r}" for k, c in
                                   zip(self.keys, self.children)) + "}"
        inner = ", ".join(repr(c) for c in self.children)
        if self.kind == "list":
            return f"[{inner}]"
        if self.kind == "tuple":
            return f"({inner})"
        return f"{self.kind.__name__}({inner})"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(tree) -> tuple[Any, tuple, list]:
    if tree is None:
        return "none", (), []
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return "dict", keys, [tree[k] for k in keys]
    if _is_namedtuple(tree):
        return type(tree), (), list(tree)
    if isinstance(tree, list):
        return "list", (), list(tree)
    if isinstance(tree, tuple):
        return "tuple", (), list(tree)
    return "leaf", (), []


def is_spec(x) -> bool:
    """A plain tuple (a shape, or a sharding spec of axis entries): the
    leaf of a tree of shapes or specs."""
    return isinstance(x, tuple) and not _is_namedtuple(x)


def _walk(node, leaves: list, is_leaf, paths, prefix: tuple) -> TreeDef:
    kind, keys, kids = _children(node)
    if kind == "leaf" or (is_leaf is not None and is_leaf(node)):
        leaves.append(node)
        if paths is not None:
            paths.append(prefix)
        return TreeDef("leaf")
    names = keys or range(len(kids))
    return TreeDef(kind, keys, tuple(
        _walk(k, leaves, is_leaf, paths, prefix + (n,))
        for n, k in zip(names, kids)))


def tree_flatten(tree, is_leaf: Optional[Callable] = None
                 ) -> tuple[list, TreeDef]:
    """The leaves in the reference's order, and the structure."""
    leaves: list = []
    return leaves, _walk(tree, leaves, is_leaf, None, ())


def tree_paths(tree, is_leaf: Optional[Callable] = None) -> list:
    """``(path, leaf)`` in flatten order: ``path`` the tuple of dict keys
    and sequence indices from the root."""
    leaves: list = []
    paths: list = []
    _walk(tree, leaves, is_leaf, paths, ())
    return list(zip(paths, leaves))


def _build(d: TreeDef, it):
    if d.kind == "leaf":
        return next(it)
    if d.kind == "none":
        return None
    kids = [_build(c, it) for c in d.children]
    if d.kind == "dict":
        return dict(zip(d.keys, kids))
    if d.kind == "list":
        return kids
    if d.kind == "tuple":
        return tuple(kids)
    return d.kind(*kids)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` holding ``leaves`` in flatten order.  (Module
    functions, not nested ones: a recursive closure would keep the leaves
    in a reference cycle until the garbage collector ran, and a training
    step's gradients with them.)"""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree, *rest,
             is_leaf: Optional[Callable] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (which must share its structure)."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = []
    for other in rest:
        o_leaves, o_def = tree_flatten(other, is_leaf)
        if o_def != treedef:
            raise ValueError(f"structures differ: {treedef!r} vs {o_def!r}")
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def value_and_grad(fn: Callable) -> Callable:
    """``jax.value_and_grad(fn, has_aux=True)`` over a tree of tensors:
    ``fn(params, *args) -> (loss, aux)`` becomes ``(params, *args) ->
    ((loss, aux), grads)`` with ``grads`` a tree like ``params``.  A leaf
    the loss does not reach gets a zero gradient, as in JAX."""

    def wrapped(params, *args):
        leaves, treedef = tree_flatten(params)
        diff = [p.detach().requires_grad_() for p in leaves]
        loss, aux = fn(tree_unflatten(treedef, diff), *args)
        grads = torch.autograd.grad(loss, diff, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(diff, grads)]
        detached = tree_map(
            lambda x: x.detach() if torch.is_tensor(x) else x, aux)
        return (loss.detach(), detached), tree_unflatten(treedef, grads)

    return wrapped
