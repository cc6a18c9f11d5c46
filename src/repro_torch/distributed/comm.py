"""Counted collectives over ``torch.distributed`` process groups.

The reference's SPMD regions (``shard_map``, GSPMD constraints) let XLA
emit the collectives, and ``core/hlo_analysis.parse_collectives`` counts
them in the compiled HLO.  The port writes each rank's program by hand, so
every collective is one call here, and each call records what it put on
the wire into the active :class:`CollectiveLedger`: its kind (the HLO
names), the bytes of its result on this rank, the group's size, and the
wire bytes a rank receives by the reference's formulas
(``CollectiveOp.wire_bytes_per_chip``).  So the ledger is the port's exact
counterpart of ``hlo_collectives``.

Each collective is a ``torch.autograd.Function``, with the gradient rule
its use in the models needs:

* :func:`all_gather` (tiled along a dim): backward reduce-scatters the
  gradient.  Each rank consumes the gathered tensor its own way (its own
  heads, queries or destination rows), so each holds a part of the
  gradient and the parts are summed.
* :func:`reduce_scatter`: backward all-gathers the gradient.
* :func:`split` (this rank's slice of a tensor every rank holds alike, no
  traffic): backward all-gathers the gradient, as each rank's slice feeds
  its own part of the computation.
* :func:`all_reduce` (sum or max): backward passes the gradient through
  unchanged.  Its result is the same on every rank and is consumed alike
  (a loss that every rank computes the same way), so each rank's gradient
  is already the whole gradient.  ``torch.distributed.nn.functional``'s
  all-reduce sums the gradient over the ranks instead, which counts a
  replicated loss once per rank.  Max passes it to the entries that hold
  the maximum.
* :func:`psum`: the sum over ranks whose backward is the same sum over
  ranks (its adjoint), for a result that each rank consumes its own way
  and whose objective is each rank's share (a GNN's readout, where every
  rank holds part of the nodes and ``1 / n`` of the loss).
* :func:`all_to_all` (equal splits along dim 0): backward is the inverse
  exchange, which for equal splits is the same exchange.
* :func:`ring_hop` (``batch_isend_irecv`` to rank + shift, from rank -
  shift): backward hops the gradient the other way.

The ring SpMM overlaps its hops with compute through :func:`start_hop`
(no autograd; its own ``Function`` gives the gradient).

Each collective's transport runs in the span ``comm.<kind>.<tag>``
(:data:`SPANS`; ``comm.<kind>`` for an untagged call or a tag outside
:data:`TAGS`), which a profiler of the program records.

Nothing here falls back: a group whose backend fails raises.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from ..obs import span

__all__ = ["CollectiveOp", "CollectiveLedger", "recording", "retagged",
           "KINDS", "TAGS", "SPANS", "group_size",
           "group_rank", "all_gather", "reduce_scatter", "split", "all_reduce",
           "psum", "all_to_all", "ring_hop", "start_hop", "all_reduce_grads"]

@dataclass(frozen=True)
class CollectiveOp:
    """One collective on this rank: the reference's ``CollectiveOp``
    without the HLO line number, and the caller's ``tag`` (what the
    collective is for, such as ``"fsdp"``; empty by default)."""

    kind: str
    result_bytes: float
    group_size: int
    tag: str = ""

    @property
    def wire_bytes_per_chip(self) -> float:
        g = self.group_size
        s = self.result_bytes
        if g <= 1 and self.kind != "collective-permute":
            return 0.0
        if self.kind == "all-gather":
            return s * (g - 1) / g
        if self.kind == "all-reduce":
            return 2.0 * s * (g - 1) / g
        if self.kind == "reduce-scatter":
            return s * (g - 1)          # operand = result * g
        if self.kind == "all-to-all":
            return s * (g - 1) / g
        if self.kind == "collective-permute":
            return s
        raise AssertionError(self.kind)


@dataclass
class CollectiveLedger:
    """The collectives one rank issued while the ledger was recording
    (:func:`recording`): the counterpart of the reference's
    ``CollectiveStats``, read by ``core.validation.validate_traffic``."""

    ops: list[CollectiveOp] = field(default_factory=list)

    @property
    def total_wire_bytes_per_chip(self) -> float:
        return sum(op.wire_bytes_per_chip for op in self.ops)

    @property
    def total_result_bytes(self) -> float:
        return sum(op.result_bytes for op in self.ops)

    def by_kind(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for op in self.ops:
            out[op.kind] = out.get(op.kind, 0.0) + op.wire_bytes_per_chip
        return out

    def by_tag(self) -> dict[str, dict[str, float]]:
        """``{tag: {kind: wire bytes a rank}}``."""
        out: dict[str, dict[str, float]] = {}
        for op in self.ops:
            kinds = out.setdefault(op.tag, {})
            kinds[op.kind] = kinds.get(op.kind, 0.0) + op.wire_bytes_per_chip
        return out

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for op in self.ops:
            out[op.kind] = out.get(op.kind, 0) + 1
        return out

    def summary(self) -> dict[str, object]:
        return {
            "wire_bytes_per_chip": self.total_wire_bytes_per_chip,
            "n_collectives": len(self.ops),
            "by_kind": self.by_kind(),
            "counts": self.counts(),
        }


_ACTIVE: list[CollectiveLedger] = []


@contextmanager
def recording(ledger: Optional[CollectiveLedger] = None
              ) -> Iterator[CollectiveLedger]:
    """Record every collective issued in the scope into ``ledger`` (a new
    one by default), which the scope yields.  Scopes nest: an inner
    ledger's collectives also reach the outer ones."""
    ledger = CollectiveLedger() if ledger is None else ledger
    _ACTIVE.append(ledger)
    try:
        yield ledger
    finally:
        _ACTIVE.remove(ledger)


#: Suffixes :func:`retagged` appends to the tags recorded in its scope.
_SUFFIXES: list[str] = []


@contextmanager
def retagged(suffix: str) -> Iterator[None]:
    """Record the collectives issued in the scope under their tag with
    ``suffix`` appended: a layer's recompute in the backward pass
    (``models.common.checkpoint_layer``) re-issues its gathers, which the
    ledger keeps apart from the forward's."""
    _SUFFIXES.append(suffix)
    try:
        yield
    finally:
        _SUFFIXES.pop()


#: The ledger's kinds of collective (the HLO names).
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")
#: The tags the program's callers give.
TAGS = ("ce", "embedding", "fsdp", "gnn_gather", "gnn_readout", "gnn_tp",
        "grad_dp", "grad_norm", "grad_tp", "metrics", "retrieval")
#: The span of each (kind, tag), and of each kind untagged (tag ``""``).
SPANS = {**{(k, ""): f"comm.{k}" for k in KINDS},
         **{(k, t): f"comm.{k}.{t}" for k in KINDS for t in TAGS}}


def _span(kind: str, tag: str = ""):
    return span(SPANS.get((kind, tag)) or SPANS[kind, ""])


def _record(kind: str, result: torch.Tensor, group, tag: str = "") -> None:
    if not _ACTIVE:
        return
    op = CollectiveOp(kind, float(result.numel() * result.element_size()),
                      group_size(group), tag + "".join(_SUFFIXES))
    for ledger in _ACTIVE:
        ledger.ops.append(op)


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _global_rank(group, rank: int) -> int:
    return dist.get_global_rank(group, rank) if group is not None else rank


# torch 2.13 renamed the tensor forms; older releases have only the old.
_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _gather(x: torch.Tensor, group, dim: int, tag: str = ""):
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((group_size(group) * xt.shape[0], *xt.shape[1:]))
    with _span("all-gather", tag):
        _gather_single(out, xt, group=group)
    out = out.movedim(0, dim).contiguous()
    _record("all-gather", out, group, tag)
    return out


def _scatter(x: torch.Tensor, group, dim: int, tag: str = ""):
    g = group_size(group)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % g:
        raise ValueError(f"reduce-scatter of {xt.shape[0]} rows over {g} "
                         "ranks")
    out = xt.new_empty((xt.shape[0] // g, *xt.shape[1:]))
    with _span("reduce-scatter", tag):
        _scatter_single(out, xt, op=dist.ReduceOp.SUM, group=group)
    out = out.movedim(0, dim).contiguous()
    _record("reduce-scatter", out, group, tag)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tag):
        ctx.group, ctx.dim, ctx.tag = group, dim, tag
        return _gather(x, group, dim, tag)

    @staticmethod
    def backward(ctx, grad):
        return _scatter(grad, ctx.group, ctx.dim, ctx.tag), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tag):
        ctx.group, ctx.dim, ctx.tag = group, dim, tag
        return _scatter(x, group, dim, tag)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.dim, ctx.tag), None, None, None


def _reduce(x: torch.Tensor, group, tag: str,
            op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    with _span("all-reduce", tag):
        dist.all_reduce(out, op=op, group=group)
    _record("all-reduce", out, group, tag)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op, tag):
        out = _reduce(x, group, tag, op)
        if op == dist.ReduceOp.MAX:
            ctx.save_for_backward(x, out)
        ctx.op = op
        return out

    @staticmethod
    def backward(ctx, grad):
        if ctx.op == dist.ReduceOp.MAX:
            x, out = ctx.saved_tensors
            return grad * (x == out).to(grad.dtype), None, None, None
        return grad, None, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return _reduce(x, group, tag)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.group, ctx.tag), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tag):
        ctx.group, ctx.dim, ctx.tag = group, dim, tag
        g = group_size(group)
        if x.shape[dim] % g:
            raise ValueError(f"split of {x.shape[dim]} rows over {g} ranks")
        n = x.shape[dim] // g
        return x.narrow(dim, group_rank(group) * n, n).clone()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.dim, ctx.tag), None, None, None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    g = group_size(group)
    if x.shape[0] != g:
        raise ValueError(f"all-to-all of {x.shape[0]} splits over {g} ranks")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    with _span("all-to-all"):
        dist.all_to_all_single(out, xc, group=group)
    _record("all-to-all", out, group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


class Hop:
    """One ring hop in flight: :meth:`wait` returns the received tensor."""

    def __init__(self, recv: torch.Tensor, works: list):
        self.recv, self.works = recv, works

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self.recv


def start_hop(x: torch.Tensor, group, shift: int = 1) -> Hop:
    """Send ``x`` to rank + ``shift`` of ``group`` and receive the same
    shape from rank - ``shift`` (one ``collective-permute``), without
    waiting: compute queued before :meth:`Hop.wait` overlaps the hop.  A
    ring of one rank has no neighbour: the hop is a copy, off the wire."""
    g, r = group_size(group), group_rank(group)
    xc = x.contiguous()
    if g == 1:
        return Hop(xc.clone(), [])
    recv = torch.empty_like(xc)
    ops = [dist.P2POp(dist.isend, xc, _global_rank(group, (r + shift) % g),
                      group),
           dist.P2POp(dist.irecv, recv, _global_rank(group, (r - shift) % g),
                      group)]
    with _span("collective-permute"):
        works = dist.batch_isend_irecv(ops)
    _record("collective-permute", recv, group)
    return Hop(recv, works)


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return start_hop(x, group, shift).wait()

    @staticmethod
    def backward(ctx, grad):
        return start_hop(grad, ctx.group, -ctx.shift).wait(), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0, *,
               tag: str = "") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order.  ``tag``
    labels the ledger entries of this gather and of its backward's
    reduce-scatter."""
    return _AllGather.apply(x, group, dim, tag)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0, *,
                   tag: str = "") -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's ``1/g`` slice along
    ``dim``."""
    return _ReduceScatter.apply(x, group, dim, tag)


def split(x: torch.Tensor, group, dim: int = 0, *,
          tag: str = "") -> torch.Tensor:
    """This rank's ``1/g`` slice along ``dim`` of an ``x`` that every rank
    of ``group`` holds alike (no traffic); the backward all-gathers the
    slices' gradients (tagged ``tag``)."""
    return _Split.apply(x, group, dim, tag)


def all_reduce(x: torch.Tensor, group, op: str = "sum", *,
               tag: str = "") -> torch.Tensor:
    """The sum (``op="sum"``) or maximum (``"max"``) over ranks of ``x``,
    as a new tensor."""
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    return _AllReduce.apply(x, group, ops[op], tag)


def psum(x: torch.Tensor, group, *, tag: str = "") -> torch.Tensor:
    """The sum over ranks of ``x``, as a new tensor; the backward sums the
    gradient over the ranks the same way (two all-reduces, tagged
    ``tag``)."""
    return _PSum.apply(x, group, tag)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all-to-all along dim 0, which must have one entry per
    rank: entry j goes to rank j, and entry i of the result came from rank
    i."""
    return _AllToAll.apply(x, group)


def ring_hop(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``x`` of rank - ``shift`` (one ring hop, waited for)."""
    return _RingHop.apply(x, group, shift)


@torch.no_grad()
def all_reduce_grads(tensors, group, *, mean: bool = False,
                     tag: str = "") -> None:
    """Data-parallel gradient sync: sum (or average) each tensor over the
    group in place, one all-reduce per tensor."""
    g = group_size(group)
    for t in tensors:
        with _span("all-reduce", tag):
            dist.all_reduce(t, group=group)
        _record("all-reduce", t, group, tag)
        if mean:
            t.div_(g)
