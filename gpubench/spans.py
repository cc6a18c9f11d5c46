"""The program's own spans on a traced window (``repro_torch.obs``: user
annotations of ``torch.profiler``, on the clock of the device events).

:func:`read` puts each device event to a **phase** and a **block** by the
runtime call that launched it, and so by the operation that made the call.
A device event and its runtime call share both ids, the runtime's
correlation id and the operation's (``linked_correlation_id``); the
operations' ids are another count, and one of them may equal a runtime
call's, so the pair is matched, never one id alone.

* the phase is the innermost phase span (:data:`PHASES`) that encloses the
  launching operation on its own thread, else, for an operation on another
  thread (the autograd engine's device thread runs the backward), the
  innermost one of another thread that encloses it in time; ``outside
  step`` where none does;
* the block is the innermost block span (:data:`BLOCKS`: message passing
  ``mp.*``, EquiformerV2's ``eqv2.*``, collectives ``comm.*``) between the
  operation and its phase, or, for an operation that the autograd engine
  ran for a node of the forward (``sequence_nr``), the block of the forward
  operation that made the node; ``(no span)`` where there is none.

Each idle gap between device events goes to the innermost program span
open at its middle, on any thread, or ``outside step``.  A program without
spans (before they were added) reads every event ``outside step``.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from . import devtrace

#: The program's phase spans: a step, its parts, a layer's recompute.
PHASES = ("step", "step.forward", "step.backward", "step.sync",
          "step.update", "remat.recompute")
#: The prefixes of its block spans.
BLOCKS = ("mp.", "eqv2.", "comm.")
OUTSIDE = "outside step"
NO_SPAN = "(no span)"


def _is_span(name: str) -> bool:
    return name in PHASES or name.startswith(BLOCKS)


def collect(prof) -> tuple[list, list, set]:
    """Device events ``(start, end, launch)``, and the host operations,
    runtime calls and program spans as :class:`devtrace.Host` (without the
    Python frames), with the indices of the spans; ``launch`` is the index
    of the event's runtime call (-1 for none)."""
    import torch

    dev, host, spans, calls = [], [], set(), {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                start = ev.start_ns()
                dev.append((start, start + ev.duration_ns(),
                            (ev.correlation_id(), ev.linked_correlation_id())))
        elif ev.start_thread_id() != ev.end_thread_id():
            continue
        elif ev.is_user_annotation():
            if _is_span(ev.name()):
                start = ev.start_ns()
                spans.add(len(host))
                host.append(devtrace.Host(
                    start, start + ev.duration_ns(), ev.start_thread_id(),
                    ev.name(), False, 0, -1, 0, list))
        else:
            h = devtrace.host_event(ev)
            if not h.python:
                if ev.linked_correlation_id():  # a runtime call
                    calls[ev.correlation_id(),
                          ev.linked_correlation_id()] = len(host)
                host.append(h)
    return ([(s, e, calls.get(ids, -1)) for s, e, ids in dev], host, spans)


def attribute(host: list, spans: set) -> tuple[list, list, list]:
    """Each host event's phase (None where no span of its thread encloses
    it), block (None for none) and innermost enclosing span (index, -1 for
    none), as the module's text says; ``host`` holds the operations and
    the spans (indices ``spans``)."""
    parent = devtrace._parents(host)
    forward: dict = {}
    for i, h in enumerate(host):
        if (i not in spans and h.seq >= 0 and h.fwd_thread == 0
                and not h.name.startswith(devtrace._EVALUATE)):
            key = (h.thread, h.seq)
            if key not in forward or host[forward[key]].start <= h.start:
                forward[key] = i  # the op that made the node starts last
    n = len(host)
    # Parents start before their children: in order of start, each event's
    # parent is settled before it.
    order = sorted(range(n), key=lambda i: (host[i].start, -host[i].end))
    phase, inner = [None] * n, [-1] * n
    for i in order:
        p = parent[i]
        if p >= 0:
            phase[i] = host[p].name if (
                p in spans and host[p].name in PHASES) else phase[p]
            inner[i] = p if p in spans else inner[p]
    block: list = [None] * n
    done = [False] * n

    def block_of(i: int):
        path, j, verdict = [], i, None
        while j >= 0:
            if done[j]:
                verdict = block[j]
                break
            path.append(j)
            h = host[j]
            if j in spans:
                verdict = None if h.name in PHASES else h.name
                break
            if h.name.startswith(devtrace._EVALUATE) and h.seq >= 0:
                f = forward.get((h.fwd_thread, h.seq))
                verdict = None if f is None else block_of(f)
                break
            j = parent[j]
        for k in path:
            block[k], done[k] = verdict, True
        return verdict

    for i in order:
        block_of(i)
    return phase, block, inner


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(busy: list, a: int, b: int) -> int:
    """Nanoseconds of the merged intervals ``busy`` inside [a, b]."""
    return sum(max(0, min(e, b) - max(s, a)) for s, e in busy
               if s < b and e > a)


def _innermost_at(times: np.ndarray, cand: list, host: list) -> np.ndarray:
    """For each time, the index into ``host`` of the latest-starting
    candidate span that encloses it (-1 for none)."""
    out = np.full(times.shape, -1, dtype=np.int64)
    for i in sorted(cand, key=lambda i: host[i].start):
        out[(times >= host[i].start) & (times <= host[i].end)] = i
    return out


def read(prof, window_s: float) -> dict:
    """The spans' reading of a finished :func:`devtrace.profiler`:
    ``busy_s`` (the union of the device events), ``device_s`` (kernel
    seconds by phase, then by block), ``idle_s`` (idle gaps' seconds by
    the span open at their middle), the ``step`` spans' count (``steps``),
    summed time (``step_s``) and the idle time inside them
    (``step_idle_s``), and ``early_kernels``: device events that start
    before the innermost span their launching operation ran under (by
    ``early_lead_s`` at most: two clocks that disagree)."""
    return reading(*collect(prof), window_s)


def reading(dev: list, host: list, spans: set, window_s: float) -> dict:
    """:func:`read` of :func:`collect`'s events."""
    phase, block, inner = attribute(host, spans)
    launch = np.array([i for _, _, i in dev], dtype=np.int64)
    # Operations of a thread without phase spans (the autograd engine's):
    # the innermost phase span of another thread at their start.
    phase_spans = [i for i in spans if host[i].name in PHASES]
    other = [k for k, i in enumerate(launch) if i >= 0 and phase[i] is None]
    if other:
        idx = launch[other]
        starts = np.array([host[i].start for i in idx], dtype=np.int64)
        threads = np.array([host[i].thread for i in idx])
        found = np.full(len(other), -1, dtype=np.int64)
        for t in set(threads.tolist()):
            sel = threads == t
            found[sel] = _innermost_at(
                starts[sel], [i for i in phase_spans if host[i].thread != t],
                host)
    cross = dict(zip(other, found.tolist())) if other else {}
    device_s: dict = defaultdict(lambda: defaultdict(float))
    early, lead = 0, 0
    for k, (s, e, _) in enumerate(dev):
        i = launch[k]
        if i < 0:
            device_s[OUTSIDE][NO_SPAN] += (e - s) / 1e9
            continue
        ph = phase[i]
        encl = inner[i]
        if ph is None:
            j = cross.get(k, -1)
            ph = host[j].name if j >= 0 else OUTSIDE
            if encl < 0:
                encl = j
        device_s[ph][block[i] or NO_SPAN] += (e - s) / 1e9
        if encl >= 0 and s < host[encl].start:
            early += 1
            lead = max(lead, host[encl].start - s)
    busy = _union([(s, e) for s, e, _ in dev])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    idle_s: dict = defaultdict(float)
    if gaps:
        mids = np.array([(a + b) // 2 for a, b in gaps], dtype=np.int64)
        at = _innermost_at(mids, sorted(spans), host)
        for (a, b), j in zip(gaps, at):
            idle_s[host[j].name if j >= 0 else OUTSIDE] += (b - a) / 1e9
    steps = [(host[i].start, host[i].end) for i in spans
             if host[i].name == "step"]
    step_ns = sum(b - a for a, b in steps)
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": window_s,
            "device_s": {p: dict(b) for p, b in device_s.items()},
            "idle_s": dict(idle_s), "steps": len(steps),
            "step_s": step_ns / 1e9,
            "step_idle_s": (step_ns - sum(_covered(busy, a, b)
                                          for a, b in steps)) / 1e9,
            "early_kernels": early, "early_lead_s": lead / 1e9}


def table(reading: dict) -> list[str]:
    """The reading as lines of text: device seconds by phase and block
    (largest first), then idle seconds by span."""
    lines = []
    for ph, blocks in sorted(reading["device_s"].items(),
                             key=lambda x: -sum(x[1].values())):
        parts = ", ".join(f"{b} {s:.4f}" for b, s in sorted(
            blocks.items(), key=lambda x: -x[1]))
        lines.append(f"device s, {ph} ({sum(blocks.values()):.4f}): {parts}")
    idle = ", ".join(f"{k} {s:.4f}" for k, s in sorted(
        reading["idle_s"].items(), key=lambda x: -x[1]))
    lines.append(f"idle s by span: {idle or 'none'}")
    return lines
