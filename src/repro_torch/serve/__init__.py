"""Serving of the port: batched greedy decode and a continuous-batching
slot engine over the LM's KV caches, and multi-tenant analytics serving
over the lane-batched Ditto executor (``engine``); continuous-batching
sessions over the same lanes (``session``) and their write-ahead log,
lane-state checkpoints and crash recovery (``durability``); the TCP front
door of a session engine, its wire codec and clients (``service``); the
serving stack's error taxonomy (``errors``)."""
from repro_torch.serve.durability import (DurableSessionEngine, WriteAheadLog,
                                          recover)
from repro_torch.serve.engine import (DecodeEngine, Request, StreamEngine,
                                      StreamRequest, greedy_generate, prefill_cache)
from repro_torch.serve.errors import EnginePreempted, SessionError
from repro_torch.serve.service import (AsyncServiceClient, FrameDecoder, ServiceClient,
                                       ServiceConfig, SessionService, TokenBucket,
                                       encode_frame)
from repro_torch.serve.session import SessionEngine, SessionStats

__all__ = ["AsyncServiceClient", "DecodeEngine", "DurableSessionEngine", "EnginePreempted",
           "FrameDecoder", "Request", "ServiceClient", "ServiceConfig", "SessionEngine",
           "SessionError", "SessionService", "SessionStats", "StreamEngine", "StreamRequest",
           "TokenBucket", "WriteAheadLog", "encode_frame", "greedy_generate", "prefill_cache",
           "recover"]
