"""The key sampler: the same seed gives the same keys, keys never repeat,
and every round of keys covers every stratum once."""
import numpy as np
import pytest
import torch

from gbench.generators import rmat
from gbench.harness.traffic import calls, key_sequence

RMAT = {"scale": 8, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
        "weights": [0.0, 1.0]}
SSSP = {"keys": "degree_at_least_1", "strata": 4, "keys_per_set": 1,
        "lanes_per_call": 1}
BFS = {"keys": "degree_at_least_1", "strata": 1, "keys_per_set": 8,
       "lanes_per_call": 4, "loop": "closed", "clients": 1}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_graph_and_keys_repeat_per_seed(seed):
    a, b = rmat.generate(RMAT, seed, "cpu"), rmat.generate(RMAT, seed, "cpu")
    assert torch.equal(a.src, b.src) and torch.equal(a.w, b.w)
    ka, kb = key_sequence(a, SSSP, seed), key_sequence(b, SSSP, seed)
    assert np.array_equal(ka, kb)
    other = key_sequence(a, SSSP, seed + 1)
    assert not np.array_equal(ka, other)


def test_keys_never_repeat_and_rounds_cover_every_stratum():
    g = rmat.generate(RMAT, 3, "cpu")
    cand = np.flatnonzero(g.degrees().numpy() >= 1)
    keys = key_sequence(g, SSSP, 3)
    per = len(cand) // 4
    assert len(np.unique(keys)) == len(keys) == 4 * per
    assert set(keys.tolist()) <= set(cand.tolist())
    stratum = np.searchsorted(cand, keys) // per
    for r in range(per):
        assert sorted(stratum[4 * r:4 * r + 4]) == [0, 1, 2, 3]


def test_graph_shapes():
    k = rmat.generate(RMAT, 1, "cpu")
    assert k.n_vertices == 256
    assert bool((k.w >= 0).all() and (k.w < 1).all())
    assert bool((k.src != k.dst).all())
    pairs = set(zip(k.src.tolist(), k.dst.tolist()))
    assert len(pairs) == k.n_directed                  # no duplicates
    assert all((d, s) in pairs for s, d in pairs)      # both directions
    m = k.n_undirected
    assert torch.equal(k.w[:m], k.w[m:])               # one weight an edge


def test_calls_cut_sets_into_lanes_and_keep_warm_up_apart():
    g = rmat.generate(RMAT, 2, "cpu")
    keys = key_sequence(g, BFS, 2)
    warm, it = calls(keys, BFS)
    served = list(it)
    assert all(len(c) == 4 for c in served)
    flat = np.concatenate(served)
    assert len(flat) % 8 == 0
    assert not set(warm.tolist()) & set(flat.tolist())


def test_only_a_closed_loop_of_one_client_is_served():
    g = rmat.generate(RMAT, 2, "cpu")
    keys = key_sequence(g, BFS, 2)
    with pytest.raises(ValueError):
        calls(keys, dict(BFS, loop="open"))
