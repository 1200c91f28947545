"""Tiered cache of converged results.

Identical ``(tenant, graph version, program, params, config)`` queries
return the same converged result (BSP fixed points are deterministic), so
serving them again should not touch the device. ``ResultCache`` layers, as
the JAX package's ``repro.serving.result_cache`` does:

  - **L1**: an in-process LRU (entry- and byte-bounded) of the result
    arrays;
  - **L2**: a pluggable :class:`ExternalStore`, the cross-process tier:
    :class:`DictStore` (in memory; tests and several pools in one
    process), :class:`FileStore` (a directory) and :class:`RedisStore`
    (a ``redis``-like client object; the ``redis`` package is optional
    and imported only by ``RedisStore.from_url``). L2 hits are promoted
    into L1.

Invalidation is by key: the key holds the session's graph version, bumped
by every applied flush, compaction and rebalance, so any mutation makes
the old entries unreachable at once; ``ttl`` (seconds, enforced lazily on
access) reaps their bytes. ``clock`` is injectable so that expiry is
testable without sleeping. Values are dicts of numpy arrays, serialized
with ``np.savez`` for the external tier. Keys are sha256 digests of the
port's own ``EngineConfig`` repr and params walk: they need not equal the
reference's digests, but they separate and join the same queries.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from repro_torch.serving.runner_cache import (_canonical_leaf, _treedef,
                                              params_leaves)

__all__ = ["ResultCache", "ResultCacheStats", "ExternalStore", "DictStore",
           "FileStore", "RedisStore", "result_key"]


def result_key(tenant, graph_version: int, program, params_c, cfg) -> str:
    """Stable digest of what determines a converged result: the graph
    (tenant + version), the computation (program type + dataclass fields +
    engine config) and the parameter values (tree structure + raw leaf
    bytes). ``warm`` is left out: warm and cold runs of a monotone program
    converge to the same fixed point."""
    h = hashlib.sha256()
    h.update(repr((str(tenant), int(graph_version),
                   type(program).__name__)).encode())
    try:
        fields = tuple((f.name, repr(getattr(program, f.name)))
                       for f in dataclasses.fields(program))
    except TypeError:
        fields = (("id", str(id(program))),)
    h.update(repr(fields).encode())
    h.update(repr(cfg).encode())
    h.update(_treedef(params_c).encode())
    for leaf in params_leaves(params_c):
        arr = _canonical_leaf(leaf)
        h.update(f"{arr.shape}{arr.dtype}".encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _serialize(value: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in value.items()})
    return buf.getvalue()


def _deserialize(data: bytes) -> dict:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: (z[k].item() if z[k].ndim == 0 else z[k])
                for k in z.files}


# --------------------------------------------------------------------------- #
# external stores (the L2 protocol)
# --------------------------------------------------------------------------- #
class ExternalStore:
    """The cross-process tier: opaque bytes keyed by the digest string, with
    an optional per-entry TTL (enforced lazily on ``get`` where the store
    cannot expire entries itself)."""

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: str, data: bytes, ttl: Optional[float] = None) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class DictStore(ExternalStore):
    """In-memory store: a dict of key -> (bytes, expiry)."""

    def __init__(self, clock=time.monotonic):
        self._d: dict = {}
        self._clock = clock

    def get(self, key):
        hit = self._d.get(key)
        if hit is None:
            return None
        data, expiry = hit
        if expiry is not None and self._clock() >= expiry:
            del self._d[key]
            return None
        return data

    def put(self, key, data, ttl=None):
        self._d[key] = (data, None if ttl is None else self._clock() + ttl)

    def delete(self, key):
        self._d.pop(key, None)

    def __len__(self):
        return len(self._d)


class FileStore(ExternalStore):
    """Directory store: one file per key, its expiry in an 8-byte
    little-endian float header (0.0 = no TTL); writes go through
    ``os.replace``, so concurrent readers see whole files."""

    def __init__(self, root: str, clock=time.time):
        self.root = root
        self._clock = clock
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.npz")

    def get(self, key):
        p = self._path(key)
        try:
            with open(p, "rb") as f:
                expiry = np.frombuffer(f.read(8), dtype="<f8")[0]
                if not (expiry and self._clock() >= expiry):
                    return f.read()
        except (FileNotFoundError, ValueError):
            return None
        self.delete(key)
        return None

    def put(self, key, data, ttl=None):
        expiry = 0.0 if ttl is None else self._clock() + ttl
        p = self._path(key)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(np.array(expiry, dtype="<f8").tobytes())
            f.write(data)
        os.replace(tmp, p)

    def delete(self, key):
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass


class RedisStore(ExternalStore):
    """Adapter over a ``redis``-like client (``get``, ``set`` with ``ex=``
    seconds, ``delete``). ``redis`` is not a dependency: pass a client, or
    ``from_url`` raises a clear ``ImportError`` where it is missing."""

    def __init__(self, client):
        self.client = client

    @classmethod
    def from_url(cls, url: str) -> "RedisStore":
        try:
            import redis  # type: ignore
        except ImportError as e:
            raise ImportError(
                "RedisStore.from_url needs the optional 'redis' package; "
                "install it or pass a constructed client to RedisStore()"
            ) from e
        return cls(redis.Redis.from_url(url))

    def get(self, key):
        return self.client.get(key)

    def put(self, key, data, ttl=None):
        if ttl is None:
            self.client.set(key, data)
        else:
            self.client.set(key, data, ex=max(1, int(round(ttl))))

    def delete(self, key):
        self.client.delete(key)


# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class ResultCacheStats:
    l1_hits: int = 0
    l2_hits: int = 0               # found in the external store (promoted)
    misses: int = 0
    puts: int = 0
    expirations: int = 0           # L1 entries reaped by the TTL on access
    l1_evictions: int = 0


class ResultCache:
    """The tiered cache. ``max_entries`` / ``max_bytes`` bound L1 (LRU;
    ``None`` = unbounded), ``store`` is the optional L2, ``ttl`` (seconds,
    ``None`` = forever) applies to both tiers. One cache may front many
    sessions: keys carry the tenant and the graph version."""

    def __init__(self, max_entries: Optional[int] = 256,
                 max_bytes: Optional[int] = None,
                 ttl: Optional[float] = None,
                 store: Optional[ExternalStore] = None,
                 clock=time.monotonic):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.ttl = ttl
        self.store = store
        self._clock = clock
        self._l1: OrderedDict = OrderedDict()   # key -> (value, expiry, bytes)
        self.stats = ResultCacheStats()

    def __len__(self):
        return len(self._l1)

    @property
    def l1_bytes(self) -> int:
        return sum(n for _, _, n in self._l1.values())

    @staticmethod
    def _nbytes(value: dict) -> int:
        return sum(np.asarray(v).nbytes for v in value.values())

    def get(self, key: str):
        """``(value, tier)`` with tier ``'l1'`` or ``'l2'``, or ``(None,
        'miss')``; an L2 hit is deserialized and promoted into L1."""
        hit = self._l1.get(key)
        if hit is not None:
            value, expiry, _ = hit
            if expiry is not None and self._clock() >= expiry:
                del self._l1[key]
                self.stats.expirations += 1
            else:
                self._l1.move_to_end(key)
                self.stats.l1_hits += 1
                return value, "l1"
        if self.store is not None:
            data = self.store.get(key)
            if data is not None:
                value = _deserialize(data)
                self._admit_l1(key, value)
                self.stats.l2_hits += 1
                return value, "l2"
        self.stats.misses += 1
        return None, "miss"

    def peek(self, key: str) -> Optional[str]:
        """The tier holding ``key`` now (``'l1'`` / ``'l2'``) or ``None``,
        without billing, promoting or refreshing: ``query_batch`` uses it
        to decide whether a whole batch can be answered before any lane is
        billed a hit."""
        hit = self._l1.get(key)
        if hit is not None and (hit[1] is None or self._clock() < hit[1]):
            return "l1"
        if self.store is not None and self.store.get(key) is not None:
            return "l2"
        return None

    def put(self, key: str, value: dict) -> None:
        """Store a converged result (a dict of numpy-able leaves) in both
        tiers."""
        self._admit_l1(key, value)
        if self.store is not None:
            self.store.put(key, _serialize(value), ttl=self.ttl)
        self.stats.puts += 1

    def _admit_l1(self, key, value):
        expiry = None if self.ttl is None else self._clock() + self.ttl
        self._l1[key] = (value, expiry, self._nbytes(value))
        self._l1.move_to_end(key)
        if self.max_entries is not None:
            while len(self._l1) > self.max_entries:
                self._l1.popitem(last=False)
                self.stats.l1_evictions += 1
        if self.max_bytes is not None:
            total = self.l1_bytes
            while total > self.max_bytes and len(self._l1) > 1:
                total -= self._l1.popitem(last=False)[1][2]
                self.stats.l1_evictions += 1

    def invalidate(self, key: str) -> None:
        """Drop one key from both tiers (graph-version keys make every
        mutation an invalidation; this is for stores shared beyond one
        session's lineage)."""
        self._l1.pop(key, None)
        if self.store is not None:
            self.store.delete(key)

    def clear_l1(self) -> None:
        self._l1.clear()
