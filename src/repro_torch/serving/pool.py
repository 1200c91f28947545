"""SessionPool — many graphs on one device, one runner cache.

A serving process hosts many long-lived graphs. ``SessionPool`` owns what a
session-per-graph loop would duplicate (the JAX package's
``repro.serving.pool``):

  - ONE :class:`~repro_torch.serving.runner_cache.RunnerCache` for every
    session: runner keys carry the bucketed padded shapes and never a
    tenant, so tenants whose graphs land in the same shape bucket reuse
    one runner;
  - one optional :class:`~repro_torch.serving.result_cache.ResultCache`,
    whose keys carry the tenant and the graph version;
  - one ``ShapePolicy``: shared bucketing is what makes same-sized graphs
    land on the same padded shapes;
  - an LRU bound on open sessions (``max_sessions``): opening one more
    closes the least recently served (``GraphSession.close`` releases its
    device graph and its pins; entries other tenants pin survive).

Every session runs on the pool's ``device`` (``None``: the CUDA card), and
with ``mesh=`` on the ``shard_map`` backend over that ``DeviceMesh``: every
rank of the job runs the same pool calls (``GraphSession``'s docstring).
What a rank decides from its own clock agrees across the mesh before a
collective follows: a result-cache hit under a TTL serves only where every
rank hits, and a ``MicroBatcher`` launches what the mesh's first rank finds
due (``batcher``'s docstring).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.result_cache import ResultCache
from repro_torch.serving.runner_cache import RunnerCache

__all__ = ["SessionPool"]


class SessionPool:
    """Host many :class:`~repro_torch.session.GraphSession` tenants on one
    device with shared caches. ``max_runners`` / ``max_runner_bytes``
    bound the SHARED runner cache (the per-session bounds are bypassed),
    ``result_cache`` attaches a shared tiered result cache,
    ``max_sessions`` closes the least recently served tenant when exceeded
    (``None`` = unbounded), ``rebalance`` is every session's default,
    ``mesh`` every session's mesh (``shard_map``; None: the simulator)."""

    def __init__(self, *, mesh=None, cfg=None, shape_policy=None,
                 max_runners: Optional[int] = 64,
                 max_runner_bytes: Optional[int] = None,
                 result_cache: Optional[ResultCache] = None,
                 max_sessions: Optional[int] = None,
                 rebalance: str = "off", device: DeviceLike = None):
        from repro_torch.core.subgraph import ShapePolicy
        self.mesh = mesh
        self.device = resolve_device(device)
        self.cfg = cfg
        self.shape_policy = shape_policy if shape_policy is not None \
            else ShapePolicy()
        self.runner_cache = RunnerCache(max_runners, max_runner_bytes)
        self.result_cache = result_cache
        self.max_sessions = max_sessions
        self.rebalance = rebalance
        self._sessions: OrderedDict = OrderedDict()   # tenant -> session
        self.sessions_closed = 0                      # by the LRU bound

    def open(self, tenant: str, graph=None, *, pg=None, edge_log=None,
             n_parts: int = 8, partitioner: str = "cdbh", ctx=None,
             **kwargs):
        """Open a session for ``tenant`` over ``graph`` (a ``Graph``),
        ``pg`` (a ``PartitionedGraph``) or ``edge_log`` (the on-disk
        ingest) — exactly one of the three. Extra kwargs go to the
        ``GraphSession`` constructor; the pool always passes its mesh,
        device, config, shape policy and shared caches."""
        from repro_torch.session import GraphSession
        if tenant in self._sessions:
            raise ValueError(f"tenant {tenant!r} already has an open "
                             "session (pool.close(tenant) first)")
        if sum(x is not None for x in (graph, pg, edge_log)) != 1:
            raise ValueError("pass exactly one of graph=, pg=, edge_log=")
        common = dict(mesh=self.mesh, cfg=self.cfg,
                      shape_policy=self.shape_policy,
                      runner_cache=self.runner_cache,
                      result_cache=self.result_cache, tenant=tenant,
                      rebalance=self.rebalance, device=self.device)
        common.update(kwargs)
        if pg is not None:
            sess = GraphSession(pg, ctx=ctx, **common)
        elif graph is not None:
            sess = GraphSession.from_graph(graph, n_parts, partitioner,
                                           **common)
        else:
            sess = GraphSession.from_edge_log(edge_log, n_parts, partitioner,
                                              **common)
        self._sessions[tenant] = sess
        self._evict_sessions()
        return sess

    def session(self, tenant: str):
        """The tenant's open session (refreshes its LRU recency)."""
        sess = self._sessions.get(tenant)
        if sess is None:
            raise KeyError(f"no open session for tenant {tenant!r}")
        self._sessions.move_to_end(tenant)
        return sess

    def __contains__(self, tenant) -> bool:
        return tenant in self._sessions

    def __len__(self) -> int:
        return len(self._sessions)

    @property
    def tenants(self) -> list:
        """Open tenants in LRU order (least recently served first)."""
        return list(self._sessions)

    def query(self, tenant: str, program, params=None, **kwargs):
        """``pool.query(t, ...)`` == ``pool.session(t).query(...)``."""
        return self.session(tenant).query(program, params, **kwargs)

    def query_batch(self, tenant: str, program, params_list, **kwargs):
        return self.session(tenant).query_batch(program, params_list,
                                                **kwargs)

    def close(self, tenant: str) -> None:
        """Close and drop one tenant's session (its pins are released;
        entries other tenants pin survive)."""
        sess = self._sessions.pop(tenant, None)
        if sess is not None:
            sess.close()

    def close_all(self) -> None:
        for t in list(self._sessions):
            self.close(t)

    def _evict_sessions(self) -> None:
        if self.max_sessions is None:
            return
        while len(self._sessions) > self.max_sessions:
            _, sess = self._sessions.popitem(last=False)
            sess.close()
            self.sessions_closed += 1

    def __enter__(self) -> "SessionPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close_all()

    def stats(self) -> dict:
        """Pool-wide snapshot: the shared runner cache (with per-tenant
        accounting), the shared result cache and each open session's
        ``SessionStats``."""
        rc = self.runner_cache
        out = dict(
            runner_cache=dict(
                entries=len(rc), bytes=rc.total_bytes, hits=rc.hits,
                misses=rc.misses, evictions=rc.evictions,
                compile_time_total=rc.compile_time_total,
                by_owner=dict(rc.by_owner)),
            sessions={t: s.stats for t, s in self._sessions.items()},
            sessions_closed=self.sessions_closed)
        if self.result_cache is not None:
            out["result_cache"] = self.result_cache.stats
        return out
