from repro_torch.algos.cc import ConnectedComponents
from repro_torch.algos.pagerank import PageRank
from repro_torch.algos.sssp import SSSP

__all__ = ["ConnectedComponents", "PageRank", "SSSP"]
