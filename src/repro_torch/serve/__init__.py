"""Serving of the port: batched greedy decode and a continuous-batching
slot engine over the LM's KV caches (``engine``)."""
