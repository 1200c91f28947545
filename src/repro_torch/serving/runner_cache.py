"""Shared runner cache of the serving layer, and the cache keys.

``RunnerCache`` is the bounded LRU of BSP runners that a ``GraphSession``
keeps, shareable across sessions so that a ``SessionPool`` hosts many
graphs with ONE cache. Runner keys carry the bucketed padded shapes and
never a tenant, so two same-bucket graphs of different tenants resolve to
the same key and reuse one runner: the pool builds each (program, param
structure, config, shapes) runner once however many tenants serve it.

What it adds over a per-session ``OrderedDict`` (the JAX package's
``repro.serving.runner_cache``, policy for policy):

  - **per-tenant pins**: every entry records the owners (tenants) that
    built or hit it, with per-owner hit / miss / build-time tallies
    (``by_owner``). Pins are bookkeeping, not locks: the bounds still
    evict.
  - **fair eviction**: on overflow the victim is the least-recently-used
    entry among the entries of the most-loaded owner (ties fall back to
    plain LRU), so a tenant that floods the cache evicts its own runners
    first. With one owner this is plain LRU.
  - **pin release**: ``release(owner)`` (``GraphSession.close``) and
    ``release_stale(owner, pred)`` (a shape-bucket change) drop an owner's
    pins; an entry nobody pins is dropped, one that other tenants pin
    survives for them.

The key helpers (``program_key``, ``canonical_params``,
``params_struct_key``, ``params_fingerprint``) live here as in the
reference; the session imports them. Keys are numpy-based: 0-d leaves of
any width normalize to int32 / float32 / bool (int64 where the value does
not fit int32), so ``{"source": 0}``, ``{"source": np.int64(0)}`` and
``{"source": np.array(0)}`` are one key.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Set

import numpy as np
import torch

from repro_torch.core.api import numpy_dtype

__all__ = ["RunnerCache", "RunnerEntry", "OwnerStats", "program_key",
           "canonical_params", "params_struct_key", "params_fingerprint",
           "params_leaves", "runner_nbytes"]


# --------------------------------------------------------------------------- #
# cache keys
# --------------------------------------------------------------------------- #
def program_key(program):
    """Hashable identity of a program's static structure: its type plus every
    dataclass field. Programs with unhashable fields fall back to identity."""
    try:
        fields = tuple((f.name, getattr(program, f.name))
                       for f in dataclasses.fields(program))
        hash(fields)
        return (type(program), fields)
    except TypeError:
        return (type(program), id(program))


def _canonical_leaf(x) -> np.ndarray:
    """A params leaf as numpy: 0-d numbers of any width normalize to int32 /
    float32 / bool (int64 where an integer does not fit int32), as the
    reference's ``canonical_params`` does, so caller habits never split the
    cache; ``ndim >= 1`` leaves keep their dtype."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    if a.ndim == 0:
        if a.dtype.kind == "b":
            return np.asarray(bool(a))
        if a.dtype.kind in "iu":
            v = int(a)
            return np.asarray(v, np.int32 if -2**31 <= v < 2**31
                              else np.int64)
        if a.dtype.kind == "f":
            return np.asarray(float(a), np.float32)
    return a


def canonical_params(params: Any) -> Any:
    """``params`` with every leaf a canonical numpy array (``None`` -> {}):
    dicts, lists and tuples keep their structure, ``None`` entries stay
    (an empty subtree, as in a JAX pytree)."""
    if params is None:
        return {}

    def canon(t):
        if isinstance(t, dict):
            return {k: canon(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(canon(v) for v in t)
        return None if t is None else _canonical_leaf(t)

    return canon(params)


def _treedef(params) -> str:
    """The structure of a params tree (dict keys sorted, leaves as ``*``)
    — what a JAX treedef separates."""
    if params is None:
        return "None"
    if isinstance(params, dict):
        return "{" + ",".join(f"{k!r}:{_treedef(params[k])}"
                              for k in sorted(params)) + "}"
    if isinstance(params, (list, tuple)):
        inner = ",".join(_treedef(v) for v in params)
        return f"[{inner}]" if isinstance(params, list) else f"({inner})"
    return "*"


def params_leaves(params) -> list:
    """The leaves of a params tree in treedef order (dict keys sorted)."""
    if params is None:
        return []
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in params_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [x for v in params for x in params_leaves(v)]
    return [params]


def params_struct_key(params) -> tuple:
    """Structure-only key (tree structure + leaf shape/dtype): runners take
    params as inputs, so different values share one runner."""
    leaves = [_canonical_leaf(x) for x in params_leaves(params)]
    return (_treedef(params),
            tuple((tuple(a.shape), a.dtype.name) for a in leaves))


def params_fingerprint(params) -> tuple:
    """Value-level key: warm results and cached converged results are
    reusable only for the same query."""
    leaves = [_canonical_leaf(x) for x in params_leaves(params)]
    return (_treedef(params),
            tuple((tuple(a.shape), a.dtype.name,
                   np.ascontiguousarray(a).tobytes()) for a in leaves))


def runner_nbytes(program, n_parts: int, v_max: int, n_slots: int,
                  lanes: int = 1, held=()) -> int:
    """Estimated device bytes one run of a runner allocates. A PyTorch
    runner has no compiled executable, so the reference's
    ``memory_analysis`` (outputs + temps + code) has no counterpart; the
    port bills a runner for what one run of it allocates on the device,
    reckoned from shapes when the runner is built:

      - the result block and the loop carry: ``v_init``, ``last_out``
        (each ``[P, v_max, K]`` like the result) and ``merged``
        (``[n_slots + 1, K]``), in the program's dtype;
      - times the lane count (``lanes``) for a batched runner;
      - plus any device tensor that the runner's closure holds (``held``;
        ``make_sim_runner``'s closures hold none: an ``'auto'`` runner
        keeps its partition groups as host index arrays).

    The inputs (the resident graph, the layouts, the warm block) belong to
    the session and are not billed. Never 0, so ``max_runner_bytes``
    really evicts."""
    item = numpy_dtype(program.dtype).itemsize
    K = program.payload
    block = n_parts * v_max * K * item
    per_lane = 3 * block + (n_slots + 1) * K * item
    return int(lanes * per_lane
               + sum(t.numel() * t.element_size() for t in held))


# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class RunnerEntry:
    """One cache slot: the runner (``compiled``, the reference's name for
    the executable) plus what the LRU policy and ``cache_info`` report.
    ``shape_key`` is ``(padded-shape key, layout key)`` — the layout key is
    None for ``coo`` runners — so a layout capacity change stales only the
    kernel runners it concerns. ``owners`` is the pin set."""
    compiled: Any
    shape_key: Any
    program: str                   # program type name (display only)
    compile_time: float = 0.0      # seconds the runner took to build
    hits: int = 0
    nbytes: int = 0                # device bytes one run allocates
                                   # (runner_nbytes)
    owners: Set[Hashable] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class OwnerStats:
    """Per-tenant accounting on a shared cache (``by_owner``)."""
    hits: int = 0
    misses: int = 0                # runner builds this owner triggered
    compile_time: float = 0.0
    evicted_pins: int = 0          # this owner's pins lost to LRU / byte
                                   # eviction


class RunnerCache:
    """Byte- and slot-bounded LRU of runners, shareable across sessions.
    ``max_entries`` / ``max_bytes``: ``None`` = unbounded; the most recent
    entry is never evicted, so a single over-budget runner still serves."""

    def __init__(self, max_entries: Optional[int] = 32,
                 max_bytes: Optional[int] = None):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[Hashable, RunnerEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compile_time_total = 0.0
        self.by_owner: Dict[Hashable, OwnerStats] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def keys(self):
        return self._entries.keys()

    @property
    def entries(self) -> OrderedDict:
        """The live key -> ``RunnerEntry`` map in LRU order (oldest first);
        mutate through the cache's methods."""
        return self._entries

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def _owner_stats(self, owner: Hashable) -> OwnerStats:
        st = self.by_owner.get(owner)
        if st is None:
            st = self.by_owner[owner] = OwnerStats()
        return st

    # ------------------------------------------------------------------ #
    def lookup(self, key: Hashable,
               owner: Hashable) -> Optional[RunnerEntry]:
        """Fetch and refresh; a hit pins ``owner`` onto the entry (how a
        tenant comes to share a runner another tenant built)."""
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            self._owner_stats(owner).misses += 1
            return None
        self._entries.move_to_end(key)
        e.hits += 1
        e.owners.add(owner)
        self.hits += 1
        self._owner_stats(owner).hits += 1
        return e

    def insert(self, key: Hashable, entry: RunnerEntry,
               owner: Hashable) -> int:
        """Admit a freshly built runner pinned by ``owner``; returns how
        many entries the bounds evicted to make room."""
        entry.owners.add(owner)
        self._entries[key] = entry
        self._entries.move_to_end(key)
        self._owner_stats(owner).compile_time += entry.compile_time
        self.compile_time_total += entry.compile_time
        return self._evict()

    # ------------------------------------------------------------------ #
    def _victim_key(self) -> Hashable:
        """The LRU entry among the most-loaded owner's entries. Load = live
        entries an owner pins (an entry pinned by several owners charges
        each); with one owner this is plain LRU."""
        load: Dict[Hashable, int] = {}
        for e in self._entries.values():
            for o in e.owners:
                load[o] = load.get(o, 0) + 1
        if not load:
            return next(iter(self._entries))
        top = max(load.values())
        heavy = {o for o, n in load.items() if n == top}
        for k, e in self._entries.items():           # oldest first
            if not e.owners or e.owners & heavy:
                return k
        return next(iter(self._entries))

    def _pop(self, key: Hashable) -> RunnerEntry:
        e = self._entries.pop(key)
        self.evictions += 1
        for o in e.owners:
            self._owner_stats(o).evicted_pins += 1
        return e

    def _evict(self) -> int:
        evicted = 0
        if self.max_entries is not None:
            while len(self._entries) > self.max_entries:
                self._pop(self._victim_key())
                evicted += 1
        if self.max_bytes is not None:
            total = self.total_bytes
            while total > self.max_bytes and len(self._entries) > 1:
                total -= self._pop(self._victim_key()).nbytes
                evicted += 1
        return evicted

    # ------------------------------------------------------------------ #
    def release(self, owner: Hashable) -> int:
        """Drop every pin ``owner`` holds; entries left with no owner are
        removed. Returns the number of entries dropped."""
        dead: List[Hashable] = []
        for k, e in self._entries.items():
            e.owners.discard(owner)
            if not e.owners:
                dead.append(k)
        for k in dead:
            del self._entries[k]
        return len(dead)

    def release_stale(self, owner: Hashable,
                      stale: Callable[[RunnerEntry], bool]) -> int:
        """Unpin ``owner`` from the entries whose shapes it left. An entry
        survives while another tenant at those shapes pins it. Returns how
        many entries this owner released (dropped or not): the session
        bills them as its shape evictions."""
        released, dead = 0, []
        for k, e in self._entries.items():
            if owner in e.owners and stale(e):
                e.owners.discard(owner)
                released += 1
                if not e.owners:
                    dead.append(k)
        for k in dead:
            del self._entries[k]
        return released

    def info(self) -> List[dict]:
        """LRU-ordered snapshot (next to be evicted first), one dict per
        entry; ``owners`` is the sorted pin set."""
        return [dict(program=e.program, shape_key=e.shape_key, hits=e.hits,
                     compile_time=e.compile_time, nbytes=e.nbytes,
                     owners=sorted(map(str, e.owners)))
                for e in self._entries.values()]
