"""Serving of the port: batched greedy decode and a continuous-batching
slot engine over the LM's KV caches, and multi-tenant analytics serving
over the lane-batched Ditto executor (``engine``); the serving stack's
error taxonomy (``errors``)."""
from repro_torch.serve.engine import (DecodeEngine, Request, StreamEngine,
                                      StreamRequest)

__all__ = ["DecodeEngine", "Request", "StreamEngine", "StreamRequest"]
