"""Zipf tuple streams, power-law graphs and the chunked streaming pipeline
(numpy only)."""
from repro_torch.data.graphs import (graph_to_edge_tuples, out_degrees,
                                     rmat_graph, uniform_graph)
from repro_torch.data.pipeline import (TupleStream, chunk_stream, pad_tail_chunk,
                                      token_batches)
from repro_torch.data.zipf import evolving_zipf_tuples, zipf_keys, zipf_tuples

__all__ = ["zipf_keys", "zipf_tuples", "evolving_zipf_tuples",
           "rmat_graph", "uniform_graph", "graph_to_edge_tuples", "out_degrees",
           "chunk_stream", "pad_tail_chunk", "TupleStream", "token_batches"]
