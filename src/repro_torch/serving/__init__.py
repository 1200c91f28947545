"""Multi-tenant serving on top of ``GraphSession`` (the JAX package's
``repro.serving``):

  - ``repro_torch.serving.runner_cache``: the shared runner LRU with
    per-tenant pins and fair eviction; same-bucket graphs of different
    tenants reuse one runner;
  - ``repro_torch.serving.result_cache``: the tiered converged-result cache
    (in-process L1, pluggable :class:`ExternalStore` L2) with TTL and
    graph-version invalidation;
  - ``repro_torch.serving.pool``: :class:`SessionPool`, many graphs on one
    device with one runner cache and one result cache;
  - ``repro_torch.serving.batcher``: :class:`MicroBatcher`, the admission
    queue that coalesces compatible requests into ``query_batch`` calls.

``SessionPool`` / ``MicroBatcher`` import lazily (PEP 562):
``repro_torch.session`` imports this package for the cache layers, and the
pool imports the session back, so eager imports here would cycle.
"""
from repro_torch.serving.result_cache import (DictStore, ExternalStore,
                                              FileStore, RedisStore,
                                              ResultCache, ResultCacheStats,
                                              result_key)
from repro_torch.serving.runner_cache import (OwnerStats, RunnerCache,
                                              RunnerEntry, canonical_params,
                                              params_fingerprint,
                                              params_struct_key, program_key,
                                              runner_nbytes)

__all__ = [
    "RunnerCache", "RunnerEntry", "OwnerStats", "program_key",
    "canonical_params", "params_struct_key", "params_fingerprint",
    "runner_nbytes",
    "ResultCache", "ResultCacheStats", "ExternalStore", "DictStore",
    "FileStore", "RedisStore", "result_key",
    "SessionPool", "MicroBatcher", "BatchPolicy", "BatcherStats",
]

_LAZY = {
    "SessionPool": "repro_torch.serving.pool",
    "MicroBatcher": "repro_torch.serving.batcher",
    "BatchPolicy": "repro_torch.serving.batcher",
    "BatcherStats": "repro_torch.serving.batcher",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
