"""The four graph examples on the port (``examples/torch_*.py``) against the
JAX package's (``examples/*.py``), both run in this process on the CPU.

Each reference example's ``main()`` prints its counts; each port example
prints the same lines and returns the counts. Every number of every printed
line must agree, timings left out: graph and partition sizes, components,
supersteps, messages, distances, top-5 ranks, edge-log and stream-buffer
sizes, slots, flushes, evictions, queries, runner builds (the reference's
compiles), warm queries and uploads. PageRank's mass is a float sum, held
to 1e-5. Without a CUDA card and without ``--device cpu`` an example
raises rather than running on the CPU."""
import contextlib
import importlib.util
import io
import math
import os
import re
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "sssp_road", "pagerank_powerlaw",
            "streaming_updates")

#: timings and rates each example prints, left out of the comparison
_TIMINGS = (r"\((?:compiled|runner built) in [\d.]+s\)", r"wall=\d+ ms",
            r"time=[\d.]+s", r"[\d.]+ Medges/s")
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e-?\d+)?")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(*args)
    return out, buf.getvalue().splitlines()


def _numbers(line):
    for pat in _TIMINGS:
        line = re.sub(pat, "", line)
    return [float(x) for x in _NUMBER.findall(line)]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_counts_match_reference(name, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _, want = _run(_load(name).main)
    got_rec, got = _run(_load(f"torch_{name}").main, ["--device", "cpu"])
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        gn, wn = _numbers(g), _numbers(w)
        assert len(gn) == len(wn), (g, w)
        if w.startswith("rank agreement"):
            assert math.isclose(gn[0], wn[0], rel_tol=1e-5), (g, w)
        else:
            assert gn == wn, (g, w)
    # the reference leaves its edge log behind; the port removes its own
    assert len(os.listdir(tmp_path)) == (name == "streaming_updates")
    _check_record(name, got_rec, [_numbers(w) for w in want])


def _check_record(name, rec, want):
    """The returned counts are the printed ones (what the card's run of the
    example is compared with)."""
    if name == "quickstart":
        assert [rec["n_vertices"], rec["n_edges"]] == want[0]
        assert [rec["n_parts"], rec["frontier"]] == [want[1][0], want[1][3]]
        assert rec["components"] == want[2][0] == \
            len(np.unique(rec["labels"]))
        assert [rec["sc_supersteps"], rec["sc_messages"]] == want[3]
        assert [rec["vc_supersteps"], rec["vc_messages"]] == want[4]
    elif name == "sssp_road":
        for mode, w in zip(("sc", "vc"), want):
            r = rec[mode]
            assert [r["supersteps"], r["messages"]] == w[:2]
            assert round(r["max_dist"], 1) == w[2]
            assert r["dist"].dtype == np.float32
    elif name == "pagerank_powerlaw":
        for part, w in zip(("cdbh", "rh-ec"), want):
            r = rec[part]
            # w: supersteps, messages, the 5 of "top5=", the five ids
            assert [r["supersteps"], r["messages"], 5] + r["top5"] == w
        assert math.isclose(rec["mass"], want[2][0], rel_tol=1e-5)
    else:
        assert [rec["n_edges"], rec["n_chunks"], rec["chunk_size"]] == \
            want[0]
        assert rec["initial_supersteps"] == want[2][0]
        for b, w in zip(rec["batches"], want[3:6]):
            assert [b["added"], b["flushes"], b["slots_before"],
                    b["slots_after"], b["cold"], b["warm"]] == w[1:]
            assert b["bit_identical"] and not b["rebuilt"]
        c = rec["compact"]
        assert [c["evicted"], *c["v_max"], *c["e_max"], *c["n_slots"]] == \
            want[6]
        assert rec["post_compact_supersteps"] == want[7][0]
        assert [rec["queries"], rec["runner_builds"], rec["warm"],
                rec["uploads"]] == want[8]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(f"torch_{name}").main([])
