"""LM serving: batched decode over KV caches and a slot scheduler.

The PyTorch counterpart of the LM half of ``repro/serve/engine.py``:
  * ``prefill_cache`` (decode steps over the prompt; a Python loop where
    the JAX version scans) and ``decode_tokens`` (one greedy token for the
    whole batch);
  * ``DecodeEngine``, a continuous-batching slot manager: requests join
    free slots mid-flight and finished slots free at once.  Per-slot
    lengths live in a [B] cache_len vector that the attention masks read.
Empty slots behave as in the JAX engine: they decode their stale token at
length 0 every tick, and those tokens enter each MoE layer's histogram and
Ditto plan.  The cache is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.zoo import Model


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


def decode_tokens(model: Model, params, tokens, cache, cache_len):
    """One greedy decode step for the batch: tokens [B] -> (next [B] int32,
    cache).  (The JAX version's temperature sampling has no caller.)"""
    logits, cache = model.decode_fn(
        params, {"tokens": tokens[:, None], "cache": cache, "cache_len": cache_len})
    return torch.argmax(logits[:, 0], dim=-1).to(torch.int32), cache


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
                # per-slot prefill at admission: cache leaves are
                # [num_periods, B, ...], so slot i is a view on axis 1 and
                # the prefill writes into the engine's cache
                cache_i = {j: type(kv)(*(t[:, i:i + 1] for t in kv))
                           for j, kv in self.cache.items()}
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
