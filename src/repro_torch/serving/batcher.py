"""MicroBatcher — the admission queue across requests.

Traffic arrives one query at a time, but ``GraphSession.query_batch``
serves a group of compatible queries in one runner call. ``MicroBatcher``
sits between the two (the JAX package's ``repro.serving.batcher``):

  - ``submit()`` enqueues a request and returns a
    ``concurrent.futures.Future`` of ``(results, ExecutionStats)`` — what
    ``query`` returns, with ``queue_time`` / ``batch_size`` filled in;
  - requests coalesce by **compatibility key**: (session, graph version,
    program, param structure, config, warm mode, result-cache use). Only
    lanes one runner can serve share a group; a group of one is a
    singleton ``query``;
  - a group launches as soon as it holds ``max_batch`` lanes (inline, on
    the submitting thread), when its oldest request has waited
    ``max_delay`` seconds (on the next ``poll()``), or when a lane's
    ``deadline`` is within ``max_delay`` of now. ``flush()`` launches
    everything; ``start()`` / ``stop()`` run ``poll()`` on a background
    thread, and the context-manager form stops (and flushes) on exit;
  - a batch launch that fails replays each lane alone through
    ``sess.query`` (same device, same kernels); a lane that fails again
    gets its own error on its future. ``BatcherStats.degraded`` counts the
    replays.

A result-cache fast path answers ``submit`` at once (no queueing, no
launch) when the session's result cache holds the converged result and no
mutation is buffered. A group key pins the graph version at submit time,
so a flush between submit and launch starts a new group.

Over a mesh (a ``shard_map`` session or pool) every launch is a collective,
so every rank must decide alike though each reads its own clock: the ranks
submit the same requests in the same order, ``poll()`` launches the groups
the mesh's first rank finds due, the fast path and the result cache's TTL
hits hold only where every rank hits, and ``start()`` raises (a pump
thread would poll at a different moment on each rank).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Optional

from repro_torch.serving.runner_cache import (canonical_params,
                                              params_struct_key, program_key)

__all__ = ["MicroBatcher", "BatchPolicy", "BatcherStats"]

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """``max_batch`` lanes launch a group at once; ``max_delay`` (seconds)
    bounds how long a group's first request waits for company. Callers
    with a latency bound pass ``deadline=`` per request instead."""
    max_batch: int = 8
    max_delay: float = 0.002


@dataclasses.dataclass
class BatcherStats:
    submitted: int = 0
    launched_batches: int = 0       # multi-lane launches
    launched_singletons: int = 0    # one-lane groups
    batched_requests: int = 0       # requests served inside batch launches
    largest_batch: int = 0
    fast_path_hits: int = 0         # answered from the result cache at
                                    # submit time, bypassing the queue
    degraded: int = 0               # lanes replayed alone after a batch
                                    # launch failed


@dataclasses.dataclass
class _Request:
    program: object
    params: object
    warm: object
    cfg: object
    future: Future
    t_enqueue: float
    deadline: Optional[float]


class _Group:
    __slots__ = ("session", "requests", "t_first")

    def __init__(self, session, t_first):
        self.session = session
        self.requests: list = []
        self.t_first = t_first


class MicroBatcher:
    """Admission queue over one ``GraphSession`` or a ``SessionPool`` (then
    pass ``tenant=`` to ``submit``). ``clock`` is injectable for tests.
    ``submit`` / ``poll`` / ``flush`` may race: the lock guards the queue
    and the counters, never device work. A session is a single-launcher
    object, so each launch runs on the thread that triggered it."""

    def __init__(self, target, policy: Optional[BatchPolicy] = None,
                 clock=time.monotonic):
        self.target = target
        self.policy = policy or BatchPolicy()
        self.clock = clock
        self.stats = BatcherStats()
        self._groups: OrderedDict = OrderedDict()    # key -> _Group
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    def _session(self, tenant):
        if hasattr(self.target, "session"):          # a SessionPool
            return self.target.session(tenant)
        return self.target

    def _count(self, **inc) -> None:
        with self._lock:
            for k, v in inc.items():
                setattr(self.stats, k, getattr(self.stats, k) + v)

    def submit(self, program, params=None, *, tenant=None, warm="auto",
               cfg=None, deadline: Optional[float] = None,
               use_result_cache=True) -> Future:
        """Enqueue one query; returns a Future of ``(results, stats)``.
        ``deadline`` is an absolute ``clock()`` time by which the request
        must launch. Resolves at once on a result-cache fast-path hit, or
        when this request fills its group to ``max_batch``."""
        sess = self._session(tenant)
        fut: Future = Future()
        now = self.clock()
        self._count(submitted=1)

        if use_result_cache and sess.result_cached(program, params, cfg):
            try:
                res, st = sess.query(program, params, warm=warm, cfg=cfg)
            except Exception as e:                   # the caller's future
                fut.set_exception(e)                 # carries the error
                return fut
            st.queue_time = 0.0
            fut.set_result((res, st))
            self._count(fast_path_hits=1)
            return fut

        key = (id(sess), sess._host_version, program_key(program),
               params_struct_key(canonical_params(params)), cfg, warm,
               use_result_cache)
        req = _Request(program=program, params=params, warm=warm, cfg=cfg,
                       future=fut, t_enqueue=now, deadline=deadline)
        launch = None
        with self._lock:
            grp = self._groups.get(key)
            if grp is None:
                grp = self._groups[key] = _Group(sess, now)
            grp.requests.append(req)
            if len(grp.requests) >= self.policy.max_batch:
                launch = self._groups.pop(key)
        if launch is not None:
            self._launch(launch)
        return fut

    def poll(self) -> int:
        """Launch every group that is due (its oldest lane waited
        ``max_delay``, or a lane's deadline is within ``max_delay`` of
        now). Returns the number of groups launched."""
        now = self.clock()
        with self._lock:
            keys = [k for k, grp in self._groups.items()
                    if self._is_due(grp, now)]
            if self._mesh is None:
                due = [self._groups.pop(k) for k in keys]
        if self._mesh is not None:
            due = self._mesh_due(set(keys))
        for grp in due:
            self._launch(grp)
        return len(due)

    def _is_due(self, grp: _Group, now: float) -> bool:
        deadlines = [r.deadline for r in grp.requests
                     if r.deadline is not None]
        return (now - grp.t_first >= self.policy.max_delay
                or bool(deadlines and now >= min(deadlines)
                        - self.policy.max_delay))

    @property
    def _mesh(self):
        return getattr(self.target, "mesh", None)

    def _mesh_due(self, mine: set) -> list:
        """Under a mesh, pop the groups that the mesh's first rank found
        due, on every rank: the ranks queue the same groups in the same
        order (they submit the same requests), but each reads its own
        clock, and a launch is a collective."""
        import torch
        import torch.distributed as dist
        from repro_torch.core.mesh import mesh_group
        group, root = mesh_group(self._mesh)
        dev = self.target.device
        with self._lock:
            keys = list(self._groups)
        n = torch.tensor([len(keys), -len(keys)], dtype=torch.int64,
                         device=dev)
        dist.all_reduce(n, op=dist.ReduceOp.MAX, group=group)
        if int(n[0]) != -int(n[1]):
            raise RuntimeError(
                f"the mesh's ranks queue between {-int(n[1])} and "
                f"{int(n[0])} groups: every rank must submit the same "
                "requests in the same order")
        if not keys:
            return []
        mask = torch.tensor([k in mine for k in keys], dtype=torch.int32,
                            device=dev)
        dist.broadcast(mask, src=root, group=group)
        with self._lock:
            return [self._groups.pop(k)
                    for k, m in zip(keys, mask.tolist()) if m]

    def flush(self) -> int:
        """Launch every pending group now."""
        with self._lock:
            due = list(self._groups.values())
            self._groups.clear()
        for grp in due:
            self._launch(grp)
        return len(due)

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(g.requests) for g in self._groups.values())

    def _launch(self, grp: _Group) -> None:
        sess, reqs = grp.session, grp.requests
        t_launch = self.clock()
        r0 = reqs[0]
        try:
            if len(reqs) == 1:
                res, st = sess.query(r0.program, r0.params, warm=r0.warm,
                                     cfg=r0.cfg)
                st.queue_time = t_launch - r0.t_enqueue
                r0.future.set_result((res, st))
                self._count(launched_singletons=1)
                return
            out = sess.query_batch(r0.program, [r.params for r in reqs],
                                   warm=r0.warm, cfg=r0.cfg)
        except Exception as batch_err:
            # a failed batch must not fail unrelated lanes: replay each
            # lane alone; a lane that fails again gets its own error
            log.debug("batch launch failed (%r); replaying %d lane(s) "
                      "alone", batch_err, len(reqs))
            for r in reqs:
                if r.future.done():
                    continue
                try:
                    res, st = sess.query(r.program, r.params, warm=r.warm,
                                         cfg=r.cfg)
                except Exception as e:
                    r.future.set_exception(e)
                    continue
                st.queue_time = t_launch - r.t_enqueue
                r.future.set_result((res, st))
                self._count(degraded=1)
            return
        for r, (res, st) in zip(reqs, out):
            st.queue_time = t_launch - r.t_enqueue
            r.future.set_result((res, st))
        with self._lock:
            self.stats.launched_batches += 1
            self.stats.batched_requests += len(reqs)
            self.stats.largest_batch = max(self.stats.largest_batch,
                                           len(reqs))

    # ------------------------------------------------------------------ #
    # background pump
    # ------------------------------------------------------------------ #
    def start(self, interval: Optional[float] = None) -> None:
        """Run ``poll()`` on a daemon thread every ``interval`` seconds
        (default ``max_delay / 2``) until ``stop()``."""
        if self._thread is not None:
            return
        if self._mesh is not None:
            raise ValueError(
                "start(): under a mesh every launch is a collective, and a "
                "pump thread would poll at a different moment on each "
                "rank; call poll() from every rank's program instead")
        interval = self.policy.max_delay / 2 if interval is None else interval
        self._stop_evt.clear()

        def pump():
            while not self._stop_evt.wait(interval):
                self.poll()

        self._thread = threading.Thread(target=pump, daemon=True,
                                        name="micro-batcher")
        self._thread.start()

    def stop(self) -> None:
        """Stop the background pump and flush what is still queued."""
        if self._thread is not None:
            self._stop_evt.set()
            self._thread.join()
            self._thread = None
        self.flush()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
