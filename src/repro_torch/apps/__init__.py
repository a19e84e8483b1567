"""The paper's five applications (Table I), each a ``DittoSpec``: HISTO,
HLL, HHD, PageRank and DP."""
from repro_torch.apps import dp, hhd, histo, hll, pagerank

__all__ = ["histo", "dp", "pagerank", "hll", "hhd"]
