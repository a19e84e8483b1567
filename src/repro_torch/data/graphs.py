"""Graph generators for the PageRank evaluation (paper §VI-C2, Fig. 8).

A copy of ``repro/data/graphs.py`` (numpy only).  The paper runs PageRank
on public and synthetic graphs in ascending degree order: undirected and
high-degree graphs give more severe destination skew (many edges update
the same vertex).  R-MAT is the power-law generator, and a near-uniform
graph is the balanced baseline; degree sets the skew.
"""
from __future__ import annotations

import numpy as np


def rmat_graph(num_vertices: int, num_edges: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               undirected: bool = True) -> np.ndarray:
    """R-MAT edge list [E, 2] int64 (src, dst).  Power-law degree gives
    skewed destination updates, the Fig. 8 regime; ``undirected`` appends
    every edge reversed (2E edges)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(num_vertices, 2))))
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for level in range(scale):
        r = rng.random(num_edges)
        # quadrant picks per Chakrabarti et al.
        go_b = (r >= a) & (r < a + b)
        go_c = (r >= a + b) & (r < a + b + c)
        go_d = r >= a + b + c
        bit = 1 << (scale - 1 - level)
        dst += bit * (go_b | go_d)
        src += bit * (go_c | go_d)
    src %= num_vertices
    dst %= num_vertices
    edges = np.stack([src, dst], axis=1)
    if undirected:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    return edges


def uniform_graph(num_vertices: int, num_edges: int, seed: int = 0) -> np.ndarray:
    """Near-uniform degree graph (directed): the paper's 'directed graphs
    have near balanced workload distribution' regime."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, num_edges, dtype=np.int64)
    dst = (src + 1 + rng.integers(0, num_vertices - 1, num_edges)) % num_vertices
    return np.stack([src, dst], axis=1)


def graph_to_edge_tuples(edges: np.ndarray) -> np.ndarray:
    """Edge list -> <dst_vertex, src_vertex> int32 tuple stream: the scatter
    phase routes each edge by its destination vertex (the buffered state)."""
    return np.stack([edges[:, 1], edges[:, 0]], axis=1).astype(np.int32)


def out_degrees(edges: np.ndarray, num_vertices: int) -> np.ndarray:
    deg = np.zeros(num_vertices, np.int64)
    np.add.at(deg, edges[:, 0], 1)
    return deg
