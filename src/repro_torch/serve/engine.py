"""Serving: batched LM decode over KV caches and a slot scheduler, and
multi-tenant analytics serving over the lane-batched Ditto executor.

The PyTorch counterpart of ``repro/serve/engine.py``.  The LM half:
  * ``prefill_cache`` (decode steps over the prompt; a Python loop where
    the JAX version scans) and ``decode_tokens`` (one token for the whole
    batch: greedy, or drawn at a temperature from a ``torch.Generator``);
  * ``DecodeEngine``, a continuous-batching slot manager: requests join
    free slots mid-flight and finished slots free at once.  Per-slot
    lengths live in a [B] cache_len vector that the attention masks read.
Empty slots behave as in the JAX engine: they decode their stale token at
length 0 every tick, and those tokens enter each MoE layer's histogram and
Ditto plan.  The cache is updated in place.  One deliberate divergence:
admission zeroes the slot's SSM state and conv tail (every ``MambaCache``)
before its prefill, where the JAX engine hands a reused slot the previous
request's (no length masks an SSM state, unlike the KV and latent caches).

The analytics half: ``StreamEngine`` runs many tenants' tuple streams
through one ``core.executor.make_multistream_executor``, as JAX's does.
It takes ``device=`` where JAX's takes ``kernel_backend=``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.core.executor import make_multistream_executor, stack_plans
from repro_torch.core.types import ExecStats, resolve_device
from repro_torch.data.pipeline import chunk_stream
from repro_torch.models.mamba2 import MambaCache
from repro_torch.models.zoo import Model
from repro_torch.tree import tree_map


def prefill_cache(model: Model, params, prompts: torch.Tensor, cache,
                  start_len: int = 0):
    """Teacher-forced prefill, one decode step per prompt position.

    prompts [B, S] -> (logits of the last position [B, V], cache)."""
    logits = None
    for i in range(prompts.shape[1]):
        logits, cache = model.decode_fn(
            params, {"tokens": prompts[:, i:i + 1], "cache": cache,
                     "cache_len": start_len + i})
    return logits[:, 0], cache


def decode_tokens(model: Model, params, tokens, cache, cache_len,
                  temperature: float = 0.0, gen: Optional[torch.Generator] = None):
    """One decode step for the batch: tokens [B] -> (next [B] int32, cache).
    Greedy unless ``temperature`` > 0 and a generator ``gen`` (on the
    logits' device) is given: then each next token is drawn from
    softmax(logits / temperature), in float32."""
    logits, cache = model.decode_fn(
        params, {"tokens": tokens[:, None], "cache": cache, "cache_len": cache_len})
    lg = logits[:, 0]
    if temperature > 0.0 and gen is not None:
        probs = torch.softmax(lg.float() / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
    else:
        nxt = torch.argmax(lg, dim=-1)
    return nxt.to(torch.int32), cache


def greedy_generate(model: Model, params, prompts: torch.Tensor, *,
                    max_new_tokens: int, max_len: Optional[int] = None):
    """prompts [B, S] -> generated [B, max_new_tokens] (greedy)."""
    b, s = prompts.shape
    cache = model.init_cache(params, b, max_len or (s + max_new_tokens))
    last_logits, cache = prefill_cache(model, params, prompts, cache)
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
    out = []
    for i in range(max_new_tokens):
        out.append(tok)
        tok, cache = decode_tokens(model, params, tok, cache, s + i)
    return torch.stack(out, dim=1)


# ----------------------------------------------------- continuous batching

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _zero_ssm_state(tree):
    """Zero every ``MambaCache`` (state and conv tail) anywhere in a cache
    tree, in place."""
    if isinstance(tree, MambaCache):
        for t in tree:
            t.zero_()
    elif isinstance(tree, dict):
        for sub in tree.values():
            _zero_ssm_state(sub)
    elif isinstance(tree, (tuple, list)):
        for sub in tree:
            _zero_ssm_state(sub)


class DecodeEngine:
    """Slot-based continuous batching over a fixed decode batch width: each
    tick decodes every slot; the host keeps the results of active slots."""

    def __init__(self, model: Model, params, *, slots: int, max_len: int):
        self.model, self.params = model, params
        self.slots, self.max_len = slots, max_len
        self.cache = model.init_cache(params, slots, max_len)
        self.slot_len = np.zeros((slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.tokens = torch.zeros((slots,), dtype=torch.int32, device=model.device)
        self.queue: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i in range(self.slots):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                # per-slot prefill at admission: every cache leaf is
                # [layers or periods, B, ...], so slot i is a view on axis 1
                # and the prefill writes into the engine's cache
                cache_i = tree_map(lambda t: t[:, i:i + 1], self.cache)
                # a request starts from a zero SSM state (the slot's last
                # request, or the empty slot's stale decodes, left one)
                _zero_ssm_state(cache_i)
                prompt = torch.as_tensor(req.prompt, dtype=torch.int32,
                                         device=self.model.device)[None, :]
                logits, _ = prefill_cache(self.model, self.params, prompt, cache_i)
                first = int(torch.argmax(logits[0]))
                req.out.append(first)
                self.slot_req[i] = req
                self.slot_len[i] = len(req.prompt)
                self.tokens[i] = first

    def step(self) -> int:
        """Admit, then decode one token for all slots; returns the number of
        active requests."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        lens = torch.as_tensor(self.slot_len, device=self.model.device)
        self.tokens, self.cache = decode_tokens(self.model, self.params,
                                                self.tokens, self.cache, lens)
        host = self.tokens.cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            req.out.append(int(host[i]))
            self.slot_len[i] += 1
            if (len(req.out) >= req.max_new_tokens
                    or self.slot_len[i] >= self.max_len - 1):
                req.done = True
                self.slot_req[i] = None
                self.slot_len[i] = 0
        return len(active)

    def run(self):
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()


# ------------------------------------------------- multi-stream analytics

@dataclasses.dataclass
class StreamRequest:
    rid: int
    chunks: np.ndarray                 # [num_chunks, chunk_size, ...]
    plan: Optional[Any] = None         # per-tenant RoutePlan (static RUN mode)
    mask: Optional[np.ndarray] = None  # bool[num_chunks, chunk] (ragged tail)


class StreamEngine:
    """Multi-tenant analytics serving: many independent tuple streams run
    through ONE lane-batched streaming executor
    (``make_multistream_executor``), so a batch of skewed workloads shares
    each chunk step, and each PE kernel launch, while every tenant keeps
    its own profiler, scheduler and plan.

    Requests are whole streams of any length (a ragged tail rides the
    pipeline's masked final chunk).  ``flush`` picks the largest group of
    compatible pending requests (same chunk count, same planned/online
    kind) each round, ties going to the oldest, pads the streams axis to
    ``max_streams`` with all-masked zero chunks (exact no-ops; never a
    tenant's data) and returns per-request (merged buffers, ExecStats) as
    numpy.

    Configuration comes from explicit (num_pri, num_sec, chunk_size) or
    from a ``repro_torch.tune.TunedPlan`` (``tuned=``).  A tenant may pin
    its own static plan per request (``submit(data, plan=...)``, a
    RoutePlan or a TunedPlan at the engine's (M, X)); such streams start
    in RUN mode under their plan and batch apart from the online ones.
    """

    def __init__(self, spec, *, num_pri: Optional[int] = None,
                 num_sec: Optional[int] = None,
                 chunk_size: Optional[int] = None, tuned=None,
                 max_streams: int = 8, device="cuda", obs=None,
                 **executor_kw):
        self.obs = obs_lib.resolve(obs)
        reg = self.obs.registry
        self._m_submits = reg.counter("stream_requests_total", "streams submitted")
        self._m_batches = reg.counter("stream_batches_total",
                                      "compatible batches run per flush")
        self._m_flush_ms = reg.histogram(
            "flush_latency_ms", "wall-clock per flush, by flush tier",
            labels=("scope",))
        if tuned is not None:
            kw = tuned.executor_kwargs()
            num_pri = kw["num_pri"] if num_pri is None else num_pri
            num_sec = kw["num_sec"] if num_sec is None else num_sec
            chunk_size = kw["chunk_size"] if chunk_size is None else chunk_size
            executor_kw.setdefault("mem_width_tuples", kw["mem_width_tuples"])
        if None in (num_pri, num_sec, chunk_size):
            raise TypeError("StreamEngine needs num_pri/num_sec/chunk_size "
                            "or tuned=TunedPlan")
        self.spec = spec
        self.num_pri, self.num_sec = num_pri, num_sec
        self.chunk_size = chunk_size
        self.max_streams = max_streams
        self.device = resolve_device(device)
        self._run_streams = make_multistream_executor(
            spec, num_pri, num_sec, chunk_size, device=self.device, obs=self.obs,
            **executor_kw)
        self._next_rid = 0
        self.pending: List[StreamRequest] = []

    def submit(self, data: np.ndarray, plan=None) -> int:
        """Enqueue a flat tuple stream [n, ...] of any length; a ragged tail
        becomes a masked final chunk.  ``plan`` optionally pins this tenant
        to a static RoutePlan (or the ``route_plan`` of a TunedPlan tuned at
        this engine's (M, X))."""
        if plan is not None and hasattr(plan, "route_plan"):
            if (plan.num_pri, plan.num_sec) != (self.num_pri, self.num_sec):
                raise ValueError(
                    f"TunedPlan is for ({plan.num_pri}P, {plan.num_sec}S); "
                    f"engine runs ({self.num_pri}P, {self.num_sec}S)")
            plan = plan.route_plan
        if plan is not None and \
                (plan.num_pri, plan.num_sec) != (self.num_pri, self.num_sec):
            raise ValueError(
                f"plan is for ({plan.num_pri}P, {plan.num_sec}S); "
                f"engine runs ({self.num_pri}P, {self.num_sec}S)")
        data = np.asarray(data)
        ragged = len(data) % self.chunk_size != 0
        ts = chunk_stream(data, self.chunk_size, pad_tail=True)
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(StreamRequest(
            rid, ts.body, plan, mask=ts.mask if ragged else None))
        self._m_submits.inc()
        return rid

    def _next_batch(self) -> List[StreamRequest]:
        """Largest compatible group of pending requests (same chunk count,
        same planned/online kind), capped at max_streams; ties break
        toward the oldest pending request so no group starves."""
        groups: Dict[tuple, List[StreamRequest]] = {}
        order: Dict[tuple, int] = {}
        for pos, r in enumerate(self.pending):
            key = (r.chunks.shape[0], r.plan is not None)
            groups.setdefault(key, []).append(r)
            order.setdefault(key, pos)
        best = max(groups, key=lambda k: (min(len(groups[k]), self.max_streams),
                                          -order[k]))
        batch = groups[best][:self.max_streams]
        batch_ids = {r.rid for r in batch}
        self.pending = [r for r in self.pending if r.rid not in batch_ids]
        return batch

    def _run_batch(self, batch: List[StreamRequest]):
        """One lane-batched run of ``batch``, padded to max_streams ->
        (merged [max_streams, ...], ExecStats [max_streams, K, ...]) as
        numpy, one device-to-host copy of each output.  Spans:
        ``stream.stack`` (the host's stack of the streams, the pad lanes,
        plans and mask), the executor's own, ``stream.drain`` (the host
        waits for the batch's device work) and ``stream.collect`` (the
        copies back)."""
        with self.obs.span("stream.stack", cat="stream"):
            stack = np.stack([r.chunks for r in batch])
            pad = self.max_streams - len(batch)
            if pad > 0:
                stack = np.concatenate([stack, np.zeros((pad, *stack.shape[1:]),
                                                        stack.dtype)])
            plans = None
            if batch[0].plan is not None:
                plans = stack_plans([r.plan for r in batch] + [batch[0].plan] * pad)
            mask = None
            if pad > 0 or any(r.mask is not None for r in batch):
                mask = torch.as_tensor(np.stack(
                    [r.mask if r.mask is not None else np.ones(r.chunks.shape[:2], bool)
                     for r in batch] + [np.zeros(batch[0].chunks.shape[:2], bool)] * pad))
            tuples = torch.as_tensor(stack)
        merged, stats = self._run_streams(tuples, plans, mask=mask)
        with self.obs.span("stream.drain", cat="stream"):
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        with self.obs.span("stream.collect", cat="stream"):
            return merged.cpu().numpy(), ExecStats(**{
                f.name: getattr(stats, f.name).cpu().numpy()
                for f in dataclasses.fields(ExecStats)})

    def flush(self) -> Dict[int, tuple]:
        """Run every pending request; returns {rid: (merged, stats)}, numpy."""
        out: Dict[int, tuple] = {}
        t0 = time.perf_counter()
        with self.obs.span("stream.flush", cat="stream", pending=len(self.pending)):
            while self.pending:
                batch = self._next_batch()
                with self.obs.span("stream.batch", cat="stream", size=len(batch),
                                   chunks=int(batch[0].chunks.shape[0]),
                                   rids=[r.rid for r in batch]):
                    merged, stats = self._run_batch(batch)
                    for i, req in enumerate(batch):
                        out[req.rid] = (merged[i], ExecStats(**{
                            f.name: getattr(stats, f.name)[i]
                            for f in dataclasses.fields(ExecStats)}))
                self._m_batches.inc()
        self._m_flush_ms.observe((time.perf_counter() - t0) * 1e3, scope="stream")
        return out
