"""The plain reference on graphs whose answers are known by hand."""
import math

import torch

from gbench.reference import paths

INF = math.inf


def _both_ways(pairs, weights):
    src = [a for a, b in pairs] + [b for a, b in pairs]
    dst = [b for a, b in pairs] + [a for a, b in pairs]
    return (torch.tensor(src), torch.tensor(dst),
            torch.tensor(weights + weights, dtype=torch.float32))


def test_shortest_paths_known_distances():
    # 0 -1.0- 1 -2.0- 2 ; 0 -4.0- 2 ; 2 -0.5- 3 ; vertex 4 isolated
    src, dst, w = _both_ways([(0, 1), (1, 2), (0, 2), (2, 3)],
                             [1.0, 2.0, 4.0, 0.5])
    d = paths.shortest_paths(src, dst, w, 5, torch.tensor([0, 3]))
    assert d[:, 0].tolist() == [0.0, 1.0, 3.0, 3.5, INF]
    assert d[:, 1].tolist() == [3.5, 2.5, 0.5, 0.0, INF]


def test_bfs_levels_and_truncated_search():
    # a path 0-1-2-3-4
    src, dst, _ = _both_ways([(0, 1), (1, 2), (2, 3), (3, 4)], [1.0] * 4)
    lv = paths.bfs_levels(src, dst, 5, torch.tensor([0, 2]))
    assert lv[:, 0].tolist() == [0, 1, 2, 3, 4]
    assert lv[:, 1].tolist() == [2, 1, 0, 1, 2]
    short = paths.bfs_levels(src, dst, 5, torch.tensor([0]), max_rounds=3)
    assert short[:, 0].tolist() == [0, 1, 2, 3, INF]


def test_float32_sums_left_to_right_and_bf16_differs():
    # 0.1 + 0.2 along a path is the float32 sum, not the exact 0.3
    src, dst, w = _both_ways([(0, 1), (1, 2)], [0.1, 0.2])
    d = paths.shortest_paths(src, dst, w, 3, torch.tensor([0]))
    want = torch.tensor(0.1, dtype=torch.float32) + torch.tensor(
        0.2, dtype=torch.float32)
    assert d[2, 0] == want
    low = paths.shortest_paths(src, dst, w, 3, torch.tensor([0]),
                               dtype=torch.bfloat16).float()
    assert low[2, 0] != want



def test_keys_beyond_one_lane_block_agree_with_one_key_at_a_time():
    n = paths.LANE_BLOCK + 4
    src, dst, w = _both_ways([(i, i + 1) for i in range(n - 1)],
                             [float(i + 1) for i in range(n - 1)])
    keys = torch.arange(n)
    together = paths.shortest_paths(src, dst, w, n, keys)
    alone = torch.cat([paths.shortest_paths(src, dst, w, n, keys[i:i + 1])
                       for i in range(n)], dim=1)
    assert together.shape == (n, n) and torch.equal(together, alone)
