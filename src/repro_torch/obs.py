"""Spans and counters of the program's own work, for a reader outside it.

A span names a phase or a block of the train step on ``torch.profiler``'s
trace: :func:`span` is ``record_function(name)`` while a profiler records,
and one shared null context otherwise, so an untraced step pays a flag
check a span (``record_function`` itself costs microseconds even with no
profiler running).  A span is a user annotation of the trace, on the clock
of the trace's device events.  Its name is one of the constants below,
never formatted on the hot path: the phases of a step (:data:`STEP` and
its ``step.*`` parts, :data:`RECOMPUTE`), the message-passing functions
(``mp.*``), EquiformerV2's blocks (``eqv2.*``) and the collectives
(``comm.<kind>.<tag>``, named by :mod:`repro_torch.distributed.comm`).

The counters are process-wide integers, as ``core.trace``'s work counters
are: what :func:`repro_torch.launch.steps.subgraph_batch` laid out.
Nothing here switches anything on; the profiler of whoever traces turns
the spans on, and the counters are read with :func:`counters`.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["STEP", "FORWARD", "BACKWARD", "SYNC", "UPDATE", "RECOMPUTE",
           "SEGMENT_SUM", "GATHER_ROWS", "SEGMENT_SOFTMAX", "SCATTER",
           "SYM_NORM", "EQV2_NORM", "EQV2_ATTENTION", "EQV2_SO2_CONV",
           "EQV2_GATE_FFN", "span", "count", "counters", "reset_counters"]

#: A whole train step (``optim.optimizers.make_step``).
STEP = "step"
#: The step's parts: the loss, its gradients, a sharded step's gradient
#: sync, the optimizer's update and its application.
FORWARD = "step.forward"
BACKWARD = "step.backward"
SYNC = "step.sync"
UPDATE = "step.update"
#: A checkpointed layer's forward run again in the backward.
RECOMPUTE = "remat.recompute"
#: The message-passing functions, one span a call.
SEGMENT_SUM = "mp.segment_sum"
GATHER_ROWS = "mp.gather_rows"
SEGMENT_SOFTMAX = "mp.segment_softmax"
SCATTER = "mp.scatter"
SYM_NORM = "mp.sym_norm"
#: EquiformerV2's blocks.
EQV2_NORM = "eqv2.norm"
EQV2_ATTENTION = "eqv2.attention"
EQV2_SO2_CONV = "eqv2.so2_conv"
EQV2_GATE_FFN = "eqv2.gate_ffn"

_OFF = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else a null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


#: Process-wide counts of the sampled batches laid out on the host.
_COUNTERS = {
    "layout.batches": 0,
    "layout.node_rows": 0,       # padded
    "layout.real_node_rows": 0,
    "layout.edge_rows": 0,       # padded
    "layout.real_edge_rows": 0,
    "layout.host_ns": 0,         # host time inside the layout
}
_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of :func:`counters`' keys)."""
    with _LOCK:
        _COUNTERS[name] += n


def counters() -> dict[str, int]:
    """A copy of every counter."""
    with _LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    """Zero every counter."""
    with _LOCK:
        for key in _COUNTERS:
            _COUNTERS[key] = 0
