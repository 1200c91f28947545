"""Continuously-updating workload on one ``GraphSession`` of the PyTorch
port: out-of-core ingest, buffered live edge traffic, auto-warm-start
incremental SSSP, membership compaction (``examples/streaming_updates.py``
on the port).

A producer appends edges to a chunked on-disk edge log; the session opens
over it with the two-pass streaming pipeline (peak edge memory bounded by
the chunk size). Producer traffic then flows through ``session.update`` —
coalesced by the internal DeltaBuffer, applied as one patch per flush — and
every ``session.query`` after an insert-only flush restarts SSSP from the
previous converged distances instead of from scratch, on the same cached
runner (no runner is rebuilt while the padded shapes hold). After a
delete-heavy phase ``session.compact()`` shrinks the padded device buffers
back down.

    PYTHONPATH=src python examples/torch_streaming_updates.py
    PYTHONPATH=src python examples/torch_streaming_updates.py --device cpu

``main`` returns the counts it prints and the last distances.
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.algos import SSSP
from repro_torch.device import resolve_device
from repro_torch.graphgen import powerlaw_graph
from repro_torch.session import GraphSession
from repro_torch.stream import write_edge_log


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = powerlaw_graph(20_000, avg_degree=8, seed=0,
                       weighted=True).as_undirected()
    log_dir = tempfile.mkdtemp(prefix="drone_edgelog_")
    try:
        meta = write_edge_log(g, log_dir, chunk_size=32_768)
        print(f"edge log: {meta.n_edges} edges in {meta.n_chunks} chunks "
              f"of {meta.chunk_size}")
        sess = GraphSession.from_edge_log(log_dir, 8, "cdbh",
                                          max_buffer_edges=512, device=dev)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    st = sess.ingest_stats
    print(f"ingest: {st.ingest_edges_per_s/1e6:.2f} Medges/s, "
          f"peak stream mem {st.peak_stream_bytes/2**20:.1f} MiB "
          f"(bound {st.stream_bound_bytes/2**20:.1f} MiB, "
          f"full edge list would be "
          f"{meta.n_edges * 20/2**20:.1f} MiB)")
    out = dict(n_edges=meta.n_edges, n_chunks=meta.n_chunks,
               chunk_size=meta.chunk_size, batches=[])

    _, stats = sess.query(SSSP(), {"source": 0})
    print(f"initial SSSP: {stats.supersteps} supersteps "
          f"(runner built in {stats.compile_time:.2f}s)")
    out["initial_supersteps"] = stats.supersteps

    # ---- continuous producer traffic through the buffered session -------- #
    rng = np.random.default_rng(1)
    for batch in range(3):
        n = g.n_edges // 200
        s = rng.integers(0, sess.pg.n_vertices, n)
        d = rng.integers(0, sess.pg.n_vertices, n)
        keep = s != d
        s, d = s[keep], d[keep]
        w = rng.uniform(5, 10, s.size).astype(np.float32)
        e_before, s_before = sess.pg.n_edges, sess.pg.n_slots
        f_before = sess.stats.flushes
        # the producer emits tiny add ops; the buffer coalesces and flushes
        for i in range(0, s.size, 64):
            sess.update(adds=(np.concatenate([s[i:i+64], d[i:i+64]]),
                              np.concatenate([d[i:i+64], s[i:i+64]]),
                              np.concatenate([w[i:i+64], w[i:i+64]])))
        sess.flush()
        warm, st_w = sess.query(SSSP(), {"source": 0})     # warm="auto"
        cold, st_c = sess.query(SSSP(), {"source": 0}, warm=False)
        ok = bool((np.asarray(warm) == np.asarray(cold)).all())
        assert ok, "warm-auto SSSP diverged from cold"
        assert st_w.supersteps < st_c.supersteps, (st_w.supersteps,
                                                   st_c.supersteps)
        rebuilt = bool(st_w.compile_time)
        row = dict(added=sess.pg.n_edges - e_before,
                   flushes=sess.stats.flushes - f_before,
                   slots_before=s_before, slots_after=sess.pg.n_slots,
                   cold=st_c.supersteps, warm=st_w.supersteps,
                   bit_identical=ok, rebuilt=rebuilt)
        out["batches"].append(row)
        print(f"batch {batch}: +{row['added']} edges in "
              f"{row['flushes']} flushes, "
              f"slots {s_before}->{sess.pg.n_slots} | "
              f"cold {st_c.supersteps} supersteps, warm {st_w.supersteps} "
              f"| bit-identical={ok} "
              f"| rebuilt={'yes' if rebuilt else 'no'}")

    # ---- delete-heavy phase, then compact the zombie members ------------- #
    sel = rng.choice(g.n_edges, size=g.n_edges // 3, replace=False)
    sess.update(deletes=(np.concatenate([g.src[sel], g.dst[sel]]),
                         np.concatenate([g.dst[sel], g.src[sel]])))
    sess.flush()
    v0, e0, s0 = sess.pg.v_max, sess.pg.e_max, sess.pg.n_slots
    cs = sess.compact()
    print(f"compact: evicted {cs.n_evicted} zombie members, "
          f"v_max {v0}->{sess.pg.v_max}, e_max {e0}->{sess.pg.e_max}, "
          f"n_slots {s0}->{sess.pg.n_slots}")
    out["compact"] = dict(evicted=cs.n_evicted, v_max=(v0, sess.pg.v_max),
                          e_max=(e0, sess.pg.e_max),
                          n_slots=(s0, sess.pg.n_slots))
    res, stats = sess.query(SSSP(), {"source": 0})
    print(f"post-compact SSSP: {stats.supersteps} supersteps "
          f"(graph unchanged by compaction, buffers smaller)")
    ss = sess.stats
    print(f"session: {ss.queries} queries, {ss.runner_builds} runner "
          f"builds, {ss.warm_queries} warm, {ss.uploads} uploads")
    out.update(post_compact_supersteps=stats.supersteps, queries=ss.queries,
               runner_builds=ss.runner_builds, warm=ss.warm_queries,
               uploads=ss.uploads, flushes=ss.flushes,
               dist=sess.pg.collect(res, fill=np.float32(np.inf)))
    return out


if __name__ == "__main__":
    main()
