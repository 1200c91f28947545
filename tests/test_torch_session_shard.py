"""A sharded ``GraphSession`` of the port against a sharded JAX session.

The reference scripts of ``tests/test_session.py`` (query, repeat, new
source, PageRank, an insert batch with warm vs cold), ``test_rebalance.py``
(a rebalance on a sharded session) and ``test_serving.py`` (a
``SessionPool(mesh=)`` with two tenants sharing a runner, ``query_batch``,
and here also a ``MicroBatcher``) run once in the JAX package — one
subprocess with 8 fake devices, no ``retrace_guard`` — and once in the port
— 8 gloo processes on a ``(2, 2, 2)`` ``DeviceMesh``
(``subgraph_axes=('pod', 'data')``, ``edge_axes=('model',)``), every rank
running the same calls. The windows queries before and after the flush
check that a flush drops the sharded device lists. Every rank's results,
supersteps and messages are held to the reference's (PageRank within
rtol = atol = 1e-5), and so are the runner-cache and warm counters.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_shard import spawn_ranks, wait_all

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = 8

SCRIPT = r"""
import os, sys
import numpy as np
out = sys.argv[1]
if os.environ.get("DRONE_SIDE") == "reference":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from repro.compat import make_mesh
    import repro.algos as A
    import repro.graphgen as G
    from repro.core import EngineConfig, build_partitioned_graph
    from repro.serving import BatchPolicy, MicroBatcher, SessionPool
    from repro.session import GraphSession
    from repro.stream.ingest import StreamContext
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    extra, name = {}, "reference"
    builds = "cache_misses"
else:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=os.environ["DRONE_INIT"],
                            rank=rank, world_size=int(os.environ["WORLD_SIZE"]))
    import repro_torch.algos as A
    import repro_torch.graphgen as G
    from repro_torch.core import EngineConfig, build_partitioned_graph
    from repro_torch.serving import BatchPolicy, MicroBatcher, SessionPool
    from repro_torch.session import GraphSession
    from repro_torch.stream.ingest import StreamContext
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    extra, name = {"device": "cpu"}, f"port_{rank}"
    builds = "runner_builds"

cfg = EngineConfig(subgraph_axes=("pod", "data"), edge_axes=("model",))
win = EngineConfig(subgraph_axes=("pod", "data"), edge_axes=("model",),
                   edge_backend="pallas_windows")
rec = {}
def keep(key, r):
    res, st = r
    rec[key + "/res"] = np.asarray(res)
    rec[key + "/counts"] = np.array([st.supersteps, st.total_messages])

# ---- the session script ------------------------------------------------- #
g = G.powerlaw_graph(400, seed=7, weighted=True).as_undirected()
sess = GraphSession.from_graph(g, 4, "cdbh", mesh=mesh, cfg=cfg, **extra)
keep("sssp0", sess.query(A.SSSP(), {"source": 0}))
r = sess.query(A.SSSP(), {"source": 0})
keep("sssp0_repeat", r)
rec["repeat_built"] = np.array([r[1].compile_time == 0.0])
keep("sssp5", sess.query(A.SSSP(), {"source": 5}))
keep("pagerank", sess.query(A.PageRank(tol=1e-9),
                            {"n_vertices": g.n_vertices}))
keep("win_before", sess.query(A.SSSP(), {"source": 3}, cfg=win))
rng = np.random.default_rng(8)
s = rng.integers(0, g.n_vertices, 32); d = rng.integers(0, g.n_vertices, 32)
keep_ = s != d; s, d = s[keep_], d[keep_]
w = rng.uniform(5, 10, s.size).astype(np.float32)
sess.update(adds=(np.concatenate([s, d]), np.concatenate([d, s]),
                  np.concatenate([w, w])))
sess.flush()
keep("warm", sess.query(A.SSSP(), {"source": 0}))
keep("cold", sess.query(A.SSSP(), {"source": 0}, warm=False))
keep("win_after", sess.query(A.SSSP(), {"source": 3}, cfg=win))
keep("auto_cc", sess.query(A.ConnectedComponents(), None,
                           cfg=EngineConfig(subgraph_axes=("pod", "data"),
                                            edge_axes=("model",),
                                            edge_backend="auto")))
st = sess.stats
rec["session_counters"] = np.array([
    st.queries, st.cache_hits, getattr(st, builds), st.warm_queries,
    st.flushes, st.uploads])

# ---- the rebalance script ----------------------------------------------- #
gr = G.powerlaw_graph(1000, alpha=2.2, avg_degree=6, seed=5)
idx = np.arange(gr.src.size)
part = np.where(idx % 10 < 7, 0, idx % 3 + 1).astype(np.int32)
pg = build_partitioned_graph(gr, part.copy(), 4)
ctx = StreamContext("rh-vc", 4, 0, gr.n_vertices,
                    np.zeros(gr.n_vertices, np.int64))
rb = GraphSession(pg, ctx=ctx, rebalance="manual", mesh=mesh, cfg=cfg,
                  **extra)
keep("rebalance_before", rb.query(A.SSSP(), {"source": 0}))
rs = rb.rebalance(target=1.0)
rec["rebalance_moved"] = np.array([rs.n_moved])
keep("rebalance_after", rb.query(A.SSSP(), {"source": 0}))
rec["rebalance_global"] = rb.pg.collect(rec["rebalance_after/res"])
rec["rebalance_edges"] = np.asarray(rb.pg.edges_per_part)

# ---- the serving script ------------------------------------------------- #
g2 = G.powerlaw_graph(400, seed=8, weighted=True).as_undirected()
pool = SessionPool(mesh=mesh, cfg=cfg, **extra)
a = pool.open("a", g, n_parts=4)
b = pool.open("b", g2, n_parts=4)
a.query(A.SSSP(), {"source": 0}, warm=False)
keep("tenant_b", b.query(A.SSSP(), {"source": 5}, warm=False))
rec["pool_cache"] = np.array([pool.runner_cache.misses,
                              pool.runner_cache.hits])
for i in range(3):
    keep(f"single{i}", a.query(A.SSSP(), {"source": i}, warm=False))
for i, r in enumerate(a.query_batch(A.SSSP(), [{"source": i}
                                               for i in range(3)],
                                    warm=False)):
    keep(f"batch{i}", r)
    rec[f"batch{i}/size"] = np.array([r[1].batch_size])
bat = MicroBatcher(pool, BatchPolicy(max_batch=2))
futs = [bat.submit(A.SSSP(), {"source": i}, tenant="a", warm=False)
        for i in range(4)]
bat.flush()
for i, f in enumerate(futs):
    keep(f"batcher{i}", f.result(timeout=120))
rec["batcher"] = np.array([bat.stats.launched_batches,
                           bat.stats.batched_requests, bat.stats.degraded])
pool.close_all()

# ---- clocks that differ between ranks (the port alone) ------------------ #
if name != "reference":
    from repro_torch.serving import ResultCache
    clk = [0.0]
    cache = ResultCache(ttl=50.0, clock=lambda: clk[0])
    tpool = SessionPool(mesh=mesh, cfg=cfg, result_cache=cache, **extra)
    t = tpool.open("t", g, n_parts=4)
    first = t.query(A.SSSP(), {"source": 0}, warm=False)
    lanes = [{"source": i} for i in range(2)]
    t.query_batch(A.SSSP(), lanes, warm=False)
    # the entries expired on rank 0 alone: every rank runs again
    clk[0] = 100.0 if rank == 0 else 10.0
    again = t.query(A.SSSP(), {"source": 0}, warm=False)
    batch = t.query_batch(A.SSSP(), lanes, warm=False)
    bclk = [0.0]
    bat = MicroBatcher(tpool, BatchPolicy(max_batch=8, max_delay=1.0),
                       clock=lambda: bclk[0])
    # the fast path holds only where every rank hits: the entry for
    # source 1, put again above, expired on every rank but rank 0
    clk[0] = 100.0 if rank == 0 else 60.0
    fut_fast = bat.submit(A.SSSP(), {"source": 1}, tenant="t", warm=False)
    bat.submit(A.SSSP(), {"source": 2}, tenant="t", warm=False)
    # due on rank 0's clock alone: every rank launches
    bclk[0] = 5.0 if rank == 0 else 0.5
    n_due = bat.poll()
    futs = [bat.submit(A.SSSP(), {"source": 3}, tenant="t", warm=False)]
    # due on every clock but rank 0's: no rank launches
    bclk[0] = 5.5 if rank == 0 else 50.0
    n_held = bat.poll()
    n_flushed = bat.flush()
    try:
        bat.start()
        refused = False
    except ValueError:
        refused = True
    rec["clock_tiers"] = np.array(
        [again[1].result_cache_tier == "miss",
         all(st.result_cache_tier == "miss" for _, st in batch),
         not fut_fast.done() or fut_fast.result()[1].queue_time != 0.0,
         n_due == 1, n_held == 0, n_flushed == 1, refused,
         bat.stats.fast_path_hits == 0])
    rec["clock_res"] = np.stack([again[0], fut_fast.result()[0],
                                 futs[0].result()[0]])
    rec["clock_first"] = np.asarray(first[0])
    tpool.close_all()
np.savez(os.path.join(out, name + ".npz"), **rec)
print("SESSION_SHARD_OK", name)
"""

KEYS = ["sssp0", "sssp0_repeat", "sssp5", "pagerank", "win_before", "warm",
        "cold", "win_after", "auto_cc", "rebalance_before",
        "rebalance_after", "tenant_b", "single0", "single1", "single2",
        "batch0", "batch1", "batch2", "batcher0", "batcher1", "batcher2",
        "batcher3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("session_shard")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               DRONE_SIDE="reference", DRONE_AUTOTUNE_DIR=str(tmp / "rt"))
    ref = subprocess.Popen([sys.executable, "-c", SCRIPT, str(tmp)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    ranks = spawn_ranks(SCRIPT, WORLD, [str(tmp)], tmp / "store",
                        dict(DRONE_SIDE="port",
                             DRONE_AUTOTUNE_DIR=str(tmp / "pt")))
    wait_all(ranks + [ref], 600,
             [f"port rank {r}" for r in range(WORLD)] + ["reference"])
    return (dict(np.load(tmp / "reference.npz")),
            [dict(np.load(tmp / f"port_{r}.npz")) for r in range(WORLD)])


@pytest.mark.parametrize("key", KEYS)
def test_query_matches_reference(runs, key):
    ref, ports = runs
    for r, got in enumerate(ports):
        if key == "pagerank":
            np.testing.assert_allclose(got[key + "/res"], ref[key + "/res"],
                                       err_msg=f"rank {r}", **TOL)
            continue
        np.testing.assert_array_equal(got[key + "/res"], ref[key + "/res"],
                                      err_msg=f"{key} rank {r}")
        np.testing.assert_array_equal(got[key + "/counts"],
                                      ref[key + "/counts"],
                                      err_msg=f"{key} rank {r}")


def test_warm_equals_cold_in_fewer_supersteps(runs):
    ref, ports = runs
    for got in ports + [ref]:
        np.testing.assert_array_equal(got["warm/res"], got["cold/res"])
        assert got["warm/counts"][0] < got["cold/counts"][0]


def test_counters_match_reference(runs):
    """Runner builds, cache hits, warm queries, flushes and uploads of the
    session; the pool's shared runner (tenant b builds none); the batch
    sizes and the batcher's launches."""
    ref, ports = runs
    for got in ports:
        for k in ("session_counters", "pool_cache", "batcher",
                  "repeat_built", "batch0/size"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert list(ref["pool_cache"]) == [1, 1]


def test_mesh_ranks_agree_on_their_clocks(runs):
    """Decisions each rank reads from its own clock agree across the mesh:
    a result-cache entry that expired on one rank alone is a miss on every
    rank (``query``, ``query_batch`` and the batcher's fast path), a
    ``poll()`` launches what the mesh's first rank finds due, and the pump
    thread is refused. A rank that decided alone would wait in a
    collective the others never enter."""
    _, ports = runs
    for r, got in enumerate(ports):
        assert got["clock_tiers"].all(), (r, got["clock_tiers"])
        np.testing.assert_array_equal(got["clock_res"][0],
                                      got["clock_first"])
        np.testing.assert_array_equal(got["clock_res"],
                                      ports[0]["clock_res"])


def test_rebalance_matches_reference(runs):
    """The same plan on every rank and in the reference; the migrated
    graph answers as before."""
    ref, ports = runs
    assert ref["rebalance_moved"][0] > 0
    for got in ports:
        for k in ("rebalance_moved", "rebalance_edges", "rebalance_global"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
