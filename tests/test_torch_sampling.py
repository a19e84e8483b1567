"""``serve.engine.decode_tokens`` at a temperature, on the CPU.

At temperature 0 (or without a generator) the next tokens are the argmax
of JAX's ``decode_tokens`` on the same weights, cache and tokens.  With a
``torch.Generator`` and temperature > 0 the tokens are draws from
softmax(logits / temperature): the same seed gives the same draws, and
over a vocabulary of 8 the draws' frequencies pass a chi-square test
against those probabilities (p > 1e-3 at a fixed seed, 40 000 draws).
The JAX version draws with ``jax.random.categorical`` from a PRNG key, so
the two packages' draws are held to the distribution, not to each other.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.models import zoo as jzoo
from repro.serve import engine as jengine
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import zoo
from repro_torch.serve import engine

ARCH = "llama3_2_3b"
B, MAX_LEN = 4, 8


@functools.cache
def _models():
    jcfg = importlib.import_module(f"repro.configs.{ARCH}").REDUCED
    jmodel = jzoo.build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, zoo.build(cfg, device="cpu"), params


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B,)).astype(np.int32)


def _port_step(tokens, **kw):
    _, _, model, params = _models()
    cache = model.init_cache(None, B, MAX_LEN)
    nxt, _ = engine.decode_tokens(model, params, torch.from_numpy(tokens), cache, 0, **kw)
    return nxt


@pytest.mark.parametrize("kw", [{}, {"temperature": 0.0, "gen": "seeded"},
                                {"temperature": 0.7}],
                         ids=["default", "zero_temperature", "no_generator"])
def test_greedy_equals_jax_argmax(kw):
    jmodel, jparams, _, _ = _models()
    toks = _tokens()
    want, _ = jengine.decode_tokens(jmodel, jparams, jnp.asarray(toks),
                                    jmodel.init_cache(None, B, MAX_LEN), 0)
    if kw.get("gen") == "seeded":
        kw = dict(kw, gen=torch.Generator().manual_seed(0))
    got = _port_step(toks, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seeded_generator_is_reproducible():
    """Sixteen steps from a generator at seed 3, twice, then at seed 4."""
    toks = _tokens(1)
    runs = []
    for seed in (3, 3, 4):
        gen = torch.Generator().manual_seed(seed)
        runs.append(torch.stack([_port_step(toks, temperature=5.0, gen=gen)
                                 for _ in range(16)]))
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert len(torch.unique(runs[0])) > 1          # a draw, not the argmax
    assert bool(((runs[0] >= 0) & (runs[0] < get_reduced(ARCH).vocab)).all())


class _FixedLogits:
    """A model whose decode step returns the same logits [B, 1, V] for
    every slot, whatever the tokens."""

    def __init__(self, logits: torch.Tensor, rows: int):
        self.logits = logits.expand(rows, 1, -1)

    def decode_fn(self, params, batch):
        del params
        return self.logits, batch["cache"]


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_draws_follow_the_tempered_softmax(temperature):
    vocab, rows, rounds = 8, 4000, 10
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, -2.0])
    model = _FixedLogits(logits, rows)
    gen = torch.Generator().manual_seed(1234)
    counts = torch.zeros(vocab, dtype=torch.int64)
    for _ in range(rounds):
        nxt, _ = engine.decode_tokens(model, None, torch.zeros(rows, dtype=torch.int32),
                                      None, 0, temperature=temperature, gen=gen)
        counts += torch.bincount(nxt.long(), minlength=vocab)
    probs = torch.softmax(logits.double() / temperature, dim=-1).numpy()
    n = rows * rounds
    assert int(counts.sum()) == n
    _, p = stats.chisquare(counts.numpy(), probs * n)
    assert p > 1e-3, (counts.tolist(), (probs * n).round(1).tolist(), p)
