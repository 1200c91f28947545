from repro_torch.algos.cc import ConnectedComponents
from repro_torch.algos.sssp import SSSP
from repro_torch.algos.pagerank import PageRank
from repro_torch.algos.gsim import GraphSimulation
from repro_torch.algos.mssp import MultiSourceSSSP
from repro_torch.algos.bfs import BFS, MultiSourceBFS, make_msbfs
from repro_torch.algos.lp import LabelPropagation, make_lp, decode_labels
from repro_torch.algos.kcore import KCore, make_kcore
from repro_torch.algos.triangles import (TriangleCount, make_triangles,
                                         triangles_from_result)
from repro_torch.algos.betweenness import (SigmaCount, BrandesAccum,
                                           brandes_betweenness)

__all__ = ["ConnectedComponents", "SSSP", "PageRank", "GraphSimulation",
           "MultiSourceSSSP", "BFS", "MultiSourceBFS", "make_msbfs",
           "LabelPropagation", "make_lp", "decode_labels",
           "KCore", "make_kcore",
           "TriangleCount", "make_triangles", "triangles_from_result",
           "SigmaCount", "BrandesAccum", "brandes_betweenness"]
