"""The needed-bytes arithmetic of the roofline metrics, against a toy of
three partitions counted by hand."""
import pytest

from gbench.harness.work import combine_bytes, product_bytes

# partition p: real directed edges, real vertex copies, sweeps of a call
EDGES = [10, 4, 0]
VERTS = [6, 3, 2]
SWEEPS = [2, 1, 3]


def test_product_bytes_weighted_one_lane():
    # p0: 2 * (10 * 12 + 6 * 8) = 336; p1: 1 * (4 * 12 + 3 * 8) = 72;
    # p2: 3 * (0 + 2 * 8) = 48
    assert product_bytes(SWEEPS, EDGES, VERTS, 1, True) == 456


def test_product_bytes_unweighted_sixteen_lanes():
    # per edge 8 B, per vertex 16 * 8 = 128 B
    # p0: 2 * (80 + 768) = 1696; p1: 1 * (32 + 384) = 416; p2: 3 * 256 = 768
    assert product_bytes(SWEEPS, EDGES, VERTS, 16, False) == 2880


def test_combine_bytes():
    # K = 1: per edge 4 + 4 = 8, per vertex 4
    # p0: 2 * (80 + 24) = 208; p1: 1 * (32 + 12) = 44; p2: 3 * 8 = 24
    assert combine_bytes(SWEEPS, EDGES, VERTS, 1) == 276
    # K = 16: per edge 68, per vertex 64
    # p0: 2 * (680 + 384) = 2128; p1: 272 + 192 = 464; p2: 3 * 128 = 384
    assert combine_bytes(SWEEPS, EDGES, VERTS, 16) == 2976


def test_unswept_partitions_cost_nothing_and_lengths_must_agree():
    assert product_bytes([0, 0, 0], EDGES, VERTS, 1, True) == 0
    with pytest.raises(ValueError):
        product_bytes([1, 1], EDGES, VERTS, 1, True)
