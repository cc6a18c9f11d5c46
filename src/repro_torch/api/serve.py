"""Scenario-serving engine: cross-request coalescing over warm caches (a
copy of the reference's ``repro/api/serve.py``, with the engine's device).

:class:`ServeEngine` accepts concurrent scenario-batch requests, holds them
for a bounded micro-batching **window**, deduplicates identical scenarios
**across requests** (:func:`~repro_torch.api.planner.coalesce_scenarios`),
evaluates the distinct set through the ordinary batch planner, which
collapses the survivors into one broadcast call per plan group, and
scatters results back per caller.

Bit-identity is inherited: a window evaluates through the same
:func:`~repro_torch.api.planner.evaluate_scenarios` a serial caller uses,
and the scatter only copies result slots, so every served number is the
serial one.  Trace and hetero groups (and tuner probes) count their
schedules with kernel K4 on the engine's ``device`` (CUDA unless
``device="cpu"``), launched from the dispatcher thread.

Shared warm state does the rest: the process-wide resolved-trace LRU and
the content-addressed disk cache (:mod:`repro_torch.core.schedule_cache`)
mean the first window pays for trace resolution and schedule computes and
later windows ride the caches.  Each result carries ``meta["serve"]``: the
window's coalesce rate, evaluation count and cache hit/miss deltas, plus
the request's own latency.

Threading model
---------------
One dispatcher thread owns the queue: it wakes on the first enqueue,
sleeps ``window_s`` to let concurrent arrivals pile up, drains the queue
(bounded by ``max_window_scenarios``) and processes the batch.  Submissions
are validated in the caller's thread: a malformed request raises
:class:`ServeError` at ``submit`` time and never reaches the loop.  An
evaluation-time failure (e.g. an unregistered dataflow) falls back to
per-request evaluation, failing only the offending requests' futures; the
loop itself never dies.

``run_once()`` drains one window synchronously on the calling thread, with
no dispatcher and no timing.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Mapping, Optional, Sequence

from ..core import schedule_cache
from ..core.trace import trace_cache_info
from .planner import ScenarioResult, coalesce_scenarios, evaluate_scenarios
from .scenario import Scenario

__all__ = ["ServeEngine", "ServeResult", "ServeError"]

#: Stats whose per-window deltas feed the ``meta["serve"]["cache"]``
#: block (keys of ``trace_cache_info()["stats"]``).
_TRACE_STAT_KEYS = ("trace_builds", "factorizations", "schedule_computes",
                    "schedule_cache_hits", "schedule_disk_hits")


class ServeError(ValueError):
    """A malformed serve request, rejected at submit time."""


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One request's results plus the window record that produced them.

    ``results`` are in the request's scenario order, each additionally
    carrying the same window record under ``meta["serve"]``.
    """

    results: tuple[ScenarioResult, ...]
    serve: Mapping[str, Any]

    def to_dict(self) -> dict:
        return {"results": [r.to_dict() for r in self.results],
                "serve": dict(self.serve)}


@dataclasses.dataclass
class _Request:
    scenarios: list[Scenario]
    future: Future
    t_submit: float


def _normalize_request(scenarios) -> list[Scenario]:
    """Validate a submission into a non-empty list of Scenarios.

    Accepts a single :class:`Scenario` / scenario dict or a sequence of
    them; anything else raises :class:`ServeError` in the caller's
    thread, so bad input can never poison the dispatcher.
    """
    if isinstance(scenarios, (Scenario, Mapping)):
        scenarios = [scenarios]
    if not isinstance(scenarios, Sequence) or isinstance(scenarios,
                                                         (str, bytes)):
        raise ServeError(
            f"a serve request is a Scenario, a scenario dict, or a "
            f"sequence of them; got {type(scenarios).__name__}")
    out: list[Scenario] = []
    for i, s in enumerate(scenarios):
        if isinstance(s, Scenario):
            out.append(s)
        elif isinstance(s, Mapping):
            try:
                out.append(Scenario.from_dict(s))
            except (TypeError, ValueError, KeyError) as exc:
                raise ServeError(
                    f"request scenario #{i} is malformed: {exc}") from exc
        else:
            raise ServeError(
                f"request scenario #{i} is {type(s).__name__}, expected "
                f"Scenario or mapping")
    if not out:
        raise ServeError("empty request: a serve request needs >= 1 scenario")
    return out


class ServeEngine:
    """Micro-batching scenario evaluation service.

    Args:
      window_s: how long the dispatcher waits after the first arrival
        for more requests to coalesce with (seconds; 0 processes each
        wakeup's backlog immediately).
      max_window_scenarios: scenario budget per window; a window closes
        early rather than exceed it (a single over-budget request still
        gets its own window — requests are never split).
      conformance_points: forwarded to
        :func:`~repro_torch.api.planner.evaluate_scenarios`.
      device: where every window evaluates (K4's schedules, conformance
        kernels): CUDA unless ``"cpu"``; without a card a window fails
        rather than run on the CPU.

    Use as a context manager (``with ServeEngine() as eng: ...``) or
    call :meth:`start` / :meth:`stop` explicitly; :meth:`stop` drains
    every queued request before returning, so no accepted future is
    left dangling.  For synchronous, timing-free operation skip
    ``start()`` entirely and call :meth:`run_once` after submitting.
    """

    def __init__(self, *, window_s: float = 0.002,
                 max_window_scenarios: int = 4096,
                 conformance_points=None, device=None) -> None:
        window_s = float(window_s)
        if not window_s >= 0.0:
            raise ValueError(f"window_s must be >= 0, got {window_s!r}")
        max_window_scenarios = int(max_window_scenarios)
        if max_window_scenarios < 1:
            raise ValueError(f"max_window_scenarios must be >= 1, "
                             f"got {max_window_scenarios!r}")
        self.window_s = window_s
        self.max_window_scenarios = max_window_scenarios
        self._conformance_points = conformance_points
        self.device = device
        self._cond = threading.Condition()
        self._queue: deque[_Request] = deque()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._metrics_lock = threading.Lock()
        self._metrics = {
            "windows": 0,
            "requests": 0,
            "scenarios": 0,
            "distinct_scenarios": 0,
            "evaluations": 0,
            "rejected_requests": 0,
            "failed_requests": 0,
            "fallback_windows": 0,
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServeEngine":
        with self._cond:
            if self._running:
                raise RuntimeError("ServeEngine is already running")
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-torch-serve",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the dispatcher, draining queued requests first."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # Anything submitted after the dispatcher exited still resolves.
        while self.run_once():
            pass

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission --------------------------------------------------------
    def submit_future(self, scenarios) -> Future:
        """Enqueue one request; returns a Future of :class:`ServeResult`."""
        try:
            normalized = _normalize_request(scenarios)
        except ServeError:
            with self._metrics_lock:
                self._metrics["rejected_requests"] += 1
            raise
        req = _Request(scenarios=normalized, future=Future(),
                       t_submit=time.perf_counter())
        with self._cond:
            self._queue.append(req)
            self._cond.notify()
        return req.future

    def submit(self, scenarios, timeout: Optional[float] = None) -> ServeResult:
        """Blocking submit: enqueue and wait for the ServeResult."""
        return self.submit_future(scenarios).result(timeout)

    async def asubmit(self, scenarios) -> ServeResult:
        """Awaitable submit for asyncio callers (wraps the Future)."""
        import asyncio

        return await asyncio.wrap_future(self.submit_future(scenarios))

    def run_once(self) -> int:
        """Drain one window synchronously; returns requests processed.

        The deterministic path: no dispatcher thread, no window timing —
        whatever is queued *now* (bounded by ``max_window_scenarios``)
        becomes exactly one coalesced window on the calling thread.
        """
        batch = self._pop_window()
        if batch:
            self._process_window(batch)
        return len(batch)

    def metrics(self) -> dict:
        """Cumulative engine counters plus the derived coalesce rate."""
        with self._metrics_lock:
            out = dict(self._metrics)
        n = out["scenarios"]
        out["coalesce_rate"] = (1.0 - out["evaluations"] / n) if n else 0.0
        return out

    # -- the dispatcher ----------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait()
                if not self._queue:
                    return  # stopped and drained
                running = self._running
            if running and self.window_s > 0.0:
                time.sleep(self.window_s)  # let concurrent arrivals land
            batch = self._pop_window()
            if batch:
                self._process_window(batch)

    def _pop_window(self) -> list[_Request]:
        out: list[_Request] = []
        n = 0
        with self._cond:
            while self._queue:
                take = len(self._queue[0].scenarios)
                if out and n + take > self.max_window_scenarios:
                    break  # next request opens the next window
                out.append(self._queue.popleft())
                n += take
        return out

    def _process_window(self, batch: list[_Request]) -> None:
        t0 = time.perf_counter()
        flat: list[Scenario] = []
        spans: list[tuple[int, int]] = []
        for req in batch:
            start = len(flat)
            flat.extend(req.scenarios)
            spans.append((start, len(flat)))
        distinct, backmap = coalesce_scenarios(flat)
        stats0 = trace_cache_info()["stats"]
        disk0 = schedule_cache.cache_stats()["counters"]
        try:
            res = evaluate_scenarios(
                distinct, device=self.device,
                conformance_points=self._conformance_points)
        except Exception:
            # One bad scenario must not fail its window-mates: re-evaluate
            # per request, failing only the offenders' futures.
            self._fallback(batch)
            return
        stats1 = trace_cache_info()["stats"]
        disk1 = schedule_cache.cache_stats()["counters"]
        # Broadcast groups + tuner runs = closed-form planner invocations
        # this window actually performed for len(flat) requested scenarios.
        n_evals = res.n_evaluations + sum(
            1 for s in distinct if s.optimize is not None)
        n = len(flat)
        sched_hits = (stats1["schedule_cache_hits"]
                      - stats0["schedule_cache_hits"])
        sched_disk = (stats1["schedule_disk_hits"]
                      - stats0["schedule_disk_hits"])
        sched_miss = (stats1["schedule_computes"]
                      - stats0["schedule_computes"])
        probed = sched_hits + sched_disk + sched_miss
        with self._metrics_lock:
            window_id = self._metrics["windows"]
            self._metrics["windows"] += 1
            self._metrics["requests"] += len(batch)
            self._metrics["scenarios"] += n
            self._metrics["distinct_scenarios"] += len(distinct)
            self._metrics["evaluations"] += n_evals
        window = {
            "window": window_id,
            "fallback": False,
            "n_requests": len(batch),
            "n_scenarios": n,
            "n_distinct_scenarios": len(distinct),
            "n_evaluations": n_evals,
            "coalesce_rate": (1.0 - n_evals / n) if n else 0.0,
            "eval_s": time.perf_counter() - t0,
            "cache": {
                **{k: stats1[k] - stats0[k] for k in _TRACE_STAT_KEYS},
                "schedule_hit_rate": ((sched_hits + sched_disk) / probed
                                      if probed else None),
                "disk_graph_hits": (disk1["graph_hits"]
                                    - disk0["graph_hits"]),
                "disk_schedule_hits": (disk1["schedule_hits"]
                                       - disk0["schedule_hits"]),
            },
        }
        done = time.perf_counter()
        for (lo, hi), req in zip(spans, batch):
            serve = {**window,
                     "request_scenarios": hi - lo,
                     "latency_s": done - req.t_submit}
            results = tuple(
                dataclasses.replace(
                    res.results[backmap[j]],
                    meta={**dict(res.results[backmap[j]].meta),
                          "serve": serve})
                for j in range(lo, hi))
            self._finish(req, ServeResult(results=results, serve=serve))

    def _fallback(self, batch: list[_Request]) -> None:
        """Per-request isolation after a window-level evaluation failure."""
        with self._metrics_lock:
            window_id = self._metrics["windows"]
            self._metrics["windows"] += 1
            self._metrics["fallback_windows"] += 1
            self._metrics["requests"] += len(batch)
        for req in batch:
            n = len(req.scenarios)
            try:
                res = evaluate_scenarios(
                    req.scenarios, device=self.device,
                    conformance_points=self._conformance_points)
            except Exception as exc:
                with self._metrics_lock:
                    self._metrics["failed_requests"] += 1
                self._finish(req, exc, is_error=True)
                continue
            n_evals = res.n_evaluations + sum(
                1 for s in req.scenarios if s.optimize is not None)
            with self._metrics_lock:
                self._metrics["scenarios"] += n
                self._metrics["distinct_scenarios"] += n
                self._metrics["evaluations"] += n_evals
            serve = {
                "window": window_id,
                "fallback": True,
                "n_requests": 1,
                "n_scenarios": n,
                "n_distinct_scenarios": n,
                "n_evaluations": n_evals,
                "coalesce_rate": 0.0,
                "request_scenarios": n,
                "latency_s": time.perf_counter() - req.t_submit,
            }
            results = tuple(
                dataclasses.replace(r, meta={**dict(r.meta), "serve": serve})
                for r in res.results)
            self._finish(req, ServeResult(results=results, serve=serve))

    @staticmethod
    def _finish(req: _Request, payload, *, is_error: bool = False) -> None:
        try:
            if is_error:
                req.future.set_exception(payload)
            else:
                req.future.set_result(payload)
        except Exception:
            pass  # caller cancelled the future; nothing left to deliver
