"""The reading of a traced window: ``torch.profiler``'s device events (one
card's kernels, copies and fills) and host operations.

Each device event is put to a layer by the host operation that launched
it (the profiler's correlation ids).  A kernel is message passing's when
that operation ran under one of the program's message-passing functions
(:data:`MESSAGE_PASSING`, by the Python frames that the trace records:
events of their own or the operations' stacks, as the profiler's version
gives them), or
in the backward of an operation that did: an operation run by the autograd
engine is put to the forward operation whose node it evaluates (the
``sequence_nr`` that the two share).  So ``segment_sum``'s float64
``index_add_``, its chunks' casts, the backward's zero fills and the sums
of the chunks' gradients all count, in the forward, the backward and a
recompute alike.  Python code that runs inside the backward (a
recompute, a Python autograd function's backward) is put by its own
frames.

The other kinds go by kernel name, with the rule of the port's chip
script (``device_time_by_kind``, copied here): NCCL kernels; dense
products (cuBLAS and CUTLASS kernels: ``nvjet``, ``gemm``, ``xmma``,
``cutlass``); copies and fills; everything else.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Callable, NamedTuple

import numpy as np

KINDS = ("nccl", "aggregate", "dense", "copies", "other")
_DENSE = ("nvjet", "gemm", "xmma", "cutlass")
#: The program's message-passing functions, by the file that holds them
#: (the SpMM's gathers and scatters, the edge softmax, the degrees).
MESSAGE_PASSING = {
    "repro_torch/models/common.py": {"segment_sum", "gather_rows",
                                     "segment_softmax"},
    "repro_torch/models/gnn/layers.py": {"gather_scatter_sum", "scatter_sum",
                                         "scatter_mean", "scatter_max"},
    "repro_torch/models/gnn/graph.py": {"sym_norm_coeffs"},
}
_FRAME = re.compile(r"^(.*)\(\d+\): (\S+)$")
_EVALUATE = "autograd::engine::evaluate_function: "


class Host(NamedTuple):
    """One host event of the trace: an operation, a runtime call or a
    Python frame; ``stack()`` gives the Python frames an operation was
    called from, where the profiler records them on the operation."""
    start: int
    end: int
    thread: int
    name: str
    python: bool
    corr: int
    seq: int
    fwd_thread: int
    stack: Callable[[], list]


def host_event(ev) -> Host:
    """The :class:`Host` of a kineto host event.  Python frames are events
    of their own where the profiler says so (``is_python_function``);
    otherwise they are in the operations' stacks."""
    flag = getattr(ev, "is_python_function", None)
    python = bool(flag()) if flag is not None else bool(
        _FRAME.match(ev.name()))
    start = ev.start_ns()
    return Host(start, start + ev.duration_ns(), ev.start_thread_id(),
                ev.name(), python, ev.correlation_id(), ev.sequence_nr(),
                ev.fwd_thread_id(), ev.stack)


def kind(name: str, message_passing: bool = False) -> str:
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if message_passing:
        return "aggregate"
    if any(f in low for f in _DENSE):
        return "dense"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other"


def is_message_passing_frame(name: str) -> bool:
    m = _FRAME.match(name)
    if m is None:
        return False
    path, func = m.groups()
    return any(path.endswith(f) and func in names
               for f, names in MESSAGE_PASSING.items())


def _parents(host: list) -> list:
    """The index of each event's innermost enclosing event on its thread
    (-1 for none)."""
    parent = [-1] * len(host)
    by_thread = defaultdict(list)
    for i, h in enumerate(host):
        by_thread[h.thread].append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (host[i].start, -host[i].end))
        stack: list = []
        for i in idx:
            while stack and host[stack[-1]].end <= host[i].start:
                stack.pop()
            if stack:
                parent[i] = stack[-1]
            stack.append(i)
    return parent


def message_passing_ops(host: list) -> set:
    """The correlation ids of the host operations that ran under message
    passing, in the forward or in its backward (see the module's text)."""
    parent = _parents(host)
    forward: dict = {}
    for i, h in enumerate(host):
        if (h.seq >= 0 and h.fwd_thread == 0 and not h.python
                and not h.name.startswith(_EVALUATE)):
            key = (h.thread, h.seq)
            if key not in forward or host[forward[key]].start <= h.start:
                forward[key] = i  # the op that made the node starts last
    memo: dict = {}

    def own_frames(j: int) -> list:
        """The frames that ``j`` was called from, where Python called it:
        an operation that its parent operation called carries the
        parent's stack, which is the parent's to judge."""
        h = host[j]
        if h.python:
            return [h.name]
        frames = h.stack()
        p = parent[j]
        if frames and p >= 0 and not host[p].python and (
                host[p].stack() == frames):
            return []
        return frames

    def under(i: int) -> bool:
        path, seen, j, verdict = [], False, i, False
        while j >= 0:
            if (j, seen) in memo:
                verdict = memo[(j, seen)]
                break
            path.append((j, seen))
            h = host[j]
            if not h.python and h.name.startswith(_EVALUATE) and h.seq >= 0:
                f = forward.get((h.fwd_thread, h.seq))
                verdict = not seen and f is not None and under(f)
                break
            frames = own_frames(j)
            if frames:
                if any(is_message_passing_frame(f) for f in frames):
                    verdict = True
                    break
                seen = True
            j = parent[j]
        for key in path:
            memo[key] = verdict
        return verdict

    return {h.corr for i, h in enumerate(host)
            if h.corr > 0 and not h.python and under(i)}


def profiler(cuda: bool):
    """The profiler of a traced window: the host's operations with the
    Python frames they were called from (``with_stack``; the verbose
    configuration has every operation carry its stack), and the card's
    kernels when ``cuda``."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts, with_stack=True,
                   experimental_config=_ExperimentalConfig(verbose=True))


def events(prof) -> tuple[list, list]:
    """(device, host) events of a finished :func:`profiler`: device events ``(start_ns, end_ns, name,
    message_passing)``, and the host operations and runtime calls
    ``(start_ns, end_ns, name)`` without the Python frames.  Read from the
    raw kineto events, which keep every event's span without building the
    tree of ``prof.events()``."""
    import torch

    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            continue
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            start = ev.start_ns()
            dev.append((start, start + ev.duration_ns(), ev.name(),
                        ev.linked_correlation_id()))
        elif ev.start_thread_id() == ev.end_thread_id():
            host.append(host_event(ev))
    under = message_passing_ops(host)
    return ([(s, e, n, link in under) for s, e, n, link in dev],
            [(h.start, h.end, h.name) for h in host if not h.python])


def summarize(dev: list, host: list, window_s: float, *, top: int = 10
              ) -> dict:
    """``busy_s`` (the union of the device events' spans), the seconds of
    each kind, and the breakdown: the ``top`` device operations by time
    and the idle gaps between device events summed by the host operation
    that was running at each gap's middle (the innermost one)."""
    by_kind = dict.fromkeys(KINDS, 0.0)
    by_name: dict = defaultdict(float)
    for s, e, name, mp in dev:
        sec = (e - s) / 1e9
        by_kind[kind(name, mp)] += sec
        by_name[name] += sec
    spans = sorted((s, e) for s, e, _, _ in dev)
    busy, gaps = 0.0, []
    if spans:
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
    idle: dict = defaultdict(float)
    if gaps and host:
        starts = np.array([h[0] for h in host], dtype=np.int64)
        ends = np.array([h[1] for h in host], dtype=np.int64)
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
            mid = (a + b) // 2
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = (host[inside[np.argmax(starts[inside])]][2]
                     if inside.size else "no host operation")
            idle[label] += (b - a) / 1e9
    return {"busy_s": busy / 1e9, "window_s": window_s, "kinds": by_kind,
            "breakdown": {
                "device_ops": [[n, s] for n, s in sorted(
                    by_name.items(), key=lambda x: -x[1])[:top]],
                "idle_gaps": [[n, s] for n, s in sorted(
                    idle.items(), key=lambda x: -x[1])[:top]]}}
