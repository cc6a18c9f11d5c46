"""What the dry run counts around one traced step: a dispatch mode that
tracks the live storages of a rank (its state and its peak) and the bytes
each operation reads and writes.

:class:`StepCounter` sits above ``FakeTensorMode`` in the mode stack and
sees every operation before it is faked:

* **live bytes.**  Every storage an operation returns is registered once,
  with its size, and dropped when Python frees it (a finalizer on the
  storage object, which PyTorch keeps alive as long as the storage).  The
  arguments a step starts from are registered by
  :meth:`StepCounter.hold`.  ``peak`` is the most that was live at once:
  what the card must hold for the step, fake tensors taking no memory.
* **operand bytes** (``op_bytes``).  Each operation's tensor inputs read
  once and its outputs written once; views, allocations, metadata and
  collectives excluded (the collectives' bytes are the ledger's), and a
  broadcast input counted at its storage's size.  It is an unfused upper bound of a
  step's HBM traffic in eager mode, where each operation is a kernel, and
  the memory term of the roofline.  A gather (K6, ``embedding``,
  ``index_select``) reads the rows its ids pick, not its whole table, as
  a run's data needs.

Nothing here allocates device memory or synchronises.
"""

from __future__ import annotations

import weakref
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["StepCounter", "tensor_bytes"]


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _operand_bytes(t: torch.Tensor) -> int:
    """The bytes an operation moves of ``t``: its elements, or its
    storage's where a broadcast (stride 0) repeats them."""
    return min(tensor_bytes(t), t.untyped_storage().nbytes())


#: Operations that move no operand bytes: allocations that write nothing,
#: metadata and aliases the schema does not mark as views.
_NO_BYTES = frozenset({
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided", "aten::_unsafe_view",
    "aten::alias", "aten::detach", "aten::lift_fresh",
    "aten::lift_fresh_copy"})


def _gather_bytes(func, args, out) -> int | None:
    """Bytes of a gather that reads only the rows its ids pick: the ids,
    the picked rows and the output; None for any other operation."""
    name = func._schema.name
    if name in ("repro_torch::embedding_bag", "repro_torch::embedding_bag_out"):
        table, ids = args[0], args[1]
        d = table.shape[1] * table.element_size()
        return (tensor_bytes(ids) + ids.numel() * d
                + ids.shape[0] * d)
    if name == "aten::embedding":
        table, ids = args[0], args[1]
        return tensor_bytes(ids) + 2 * tensor_bytes(out)
    if name == "aten::index_select":
        ids = args[2]
        return tensor_bytes(ids) + 2 * tensor_bytes(out)
    return None


class StepCounter(TorchDispatchMode):
    """Live, peak and operand bytes of the operations run under it (see
    the module's docstring)."""

    def __init__(self):
        super().__init__()
        self._sizes: dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self.op_bytes = 0

    # ---- live storages ---------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _register(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def hold(self, tensors: Iterable) -> int:
        """Register the storages of ``tensors`` (a tree), made before the
        mode saw them; returns the bytes they hold."""
        before = self.live
        for t in tree_leaves(tensors):
            if isinstance(t, torch.Tensor):
                self._register(t)
        return self.live - before

    def reset_peak(self) -> None:
        self.peak = self.live

    # ---- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._register(t)
        if (func.namespace not in ("c10d", "prim") and not func.is_view
                and func._schema.name not in _NO_BYTES):
            moved = _gather_bytes(func, args, out)
            if moved is None:
                moved = sum(_operand_bytes(t)
                            for t in tree_leaves((args, kwargs))
                            if isinstance(t, torch.Tensor))
                moved += sum(tensor_bytes(t) for t in outs)
            self.op_bytes += moved
        return out
