"""Parity of the port's training path with the JAX package's, on the CPU,
at REDUCED configs in float32.

Both packages run the same weights (the JAX ``init_params`` tree carried
over by ``interop``) and the same numpy batches.  Tolerances:
  * losses within rtol = 1e-5; every gradient leaf within rtol = 1e-4,
    atol = 1e-4 * (1 + max |gradient of the leaf|) (sums in another order);
  * one optimizer step: params and float32 moments within rtol = atol =
    1e-4 (the global norm sums the leaves in another order than JAX's);
    the 8-bit moments dequantized, and the compression residuals, within
    one code of their row (a code may round the other way);
  * ``_quantize`` codes and scales bit for bit on identical float32
    inputs, ties included (``torch.round`` and ``jnp.round`` both round
    half to even); the schedules within rtol = 1e-6;
  * the corpus bytes, and the token batches, identical.
Every family trains: this file holds the dense, VLM and encoder-decoder
configs; tests/test_torch_train_families.py the MoE, MLA, SSM and hybrid
ones with the same helpers and tolerances.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import pipeline as jpipeline
from repro.models import zoo as jzoo
from repro.train import loop as jloop
from repro.train import state as jstate
from repro_torch import configs
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.data import pipeline
from repro_torch.interop import lm_params_from_numpy, whisper_params_from_numpy
from repro_torch.models import zoo
from repro_torch.train import loop
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_leaves, tree_map

# the optimizer modules (the packages export functions of the same names)
jadamw = importlib.import_module("repro.optim.adamw")
jschedules = importlib.import_module("repro.optim.schedules")
adamw = importlib.import_module("repro_torch.optim.adamw")
schedules = importlib.import_module("repro_torch.optim.schedules")

TRAINED = ("llama3_2_3b", "gemma2_2b", "yi_6b", "starcoder2_15b", "phi3_vision_4_2b",
           "whisper_base")


@functools.cache
def _models(arch):
    jcfg = importlib.import_module(f"repro.configs.{arch}").REDUCED
    jmodel = jzoo.build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = configs.get_reduced(arch)
    model = zoo.build(cfg, device="cpu")
    convert = whisper_params_from_numpy if cfg.family == "encdec" else lm_params_from_numpy
    params = convert(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


def _batch(cfg, b=2, s=16, seed=0):
    """Numpy tokens and next-token labels (and frames or patches)."""
    rng = np.random.default_rng(seed)
    st = s - cfg.num_patches if cfg.num_patches else s
    toks = rng.integers(0, cfg.vocab, (b, st + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal((b, cfg.encoder_len, cfg.d_model))
                         * 0.02).astype(np.float32)
    if cfg.num_patches:
        out["patches"] = (rng.standard_normal((b, cfg.num_patches, cfg.patch_embed_dim))
                          * 0.02).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_tree_close(got, want, rtol=1e-4, atol=1e-4):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().float().numpy(), w.astype(np.float32),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_fn_vs_jax(arch):
    """loss_fn of every REDUCED config under no_grad (the path serving's
    forward takes, no autograd Function): the loss, its cross-entropy and
    the MoE load-balance term (weight 0.01).  The gradients are compared in
    test_loss_and_grads_vs_jax and in test_torch_train_families.py."""
    jmodel, jparams, model, params = _models(arch)
    batch = _batch(model.cfg, s=64 if model.cfg.family in ("moe", "hybrid") else 16)
    want, jm = jmodel.loss_fn(jparams, _jax(batch))
    with torch.no_grad():
        got, m = model.loss_fn(params, _torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["lb_loss"]), float(jm["lb_loss"]), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_grads_vs_jax(arch):
    """The loss and every gradient leaf against jax.value_and_grad: llama,
    gemma2 (attention and logit caps, its window of 8 under 16 tokens), yi
    and starcoder2 (GQA, the GELU MLP), phi-3-vision (patch positions
    dropped from the loss) and whisper."""
    jmodel, jparams, model, params = _models(arch)
    batch = _batch(model.cfg, seed=1)
    (want, _), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, _jax(batch))
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    got, _ = model.loss_fn(leaves, _torch(batch))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(tree_leaves(leaves), jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * (1 + np.abs(w).max()))


def _jax_step(jmodel, optimizer, jparams, batch, compress=False):
    comp = (jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
            if compress else None)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                              opt_state=optimizer.init(jparams), comp_state=comp)
    step = jax.jit(jloop.make_train_step(jmodel, optimizer, compress_grads=compress))
    return state, step


def _port_state(model, optimizer, params, compress=False):
    comp = tree_map(lambda p: torch.zeros(p.shape), params) if compress else None
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params,
                      opt_state=optimizer.init(params), comp_state=comp)


@pytest.mark.parametrize("opt,compress", [("adamw", False), ("adamw8bit", False),
                                          ("adamw", True)],
                         ids=["adamw", "adamw8bit", "compress_grads"])
@pytest.mark.parametrize("arch", ["llama3_2_3b", "whisper_base"])
def test_train_step_vs_jax(arch, opt, compress):
    """make_train_step steps (clip 1.0, warmup_cosine): params, the
    optimizer state and the compression residual against JAX's.  Two steps;
    one for adamw8bit, whose second step reads moments whose codes may
    round the other way where the first step's float32 inputs differ in
    the last bits (a code is 1/127 of its row's largest moment)."""
    jmodel, jparams, model, params = _models(arch)
    jopt = jadamw.make_optimizer(opt, jschedules.warmup_cosine(1e-3, 1, 4))
    popt = adamw.make_optimizer(opt, schedules.warmup_cosine(1e-3, 1, 4))
    jst, jstep = _jax_step(jmodel, jopt, jparams, None, compress)
    st = _port_state(model, popt, params, compress)
    step = loop.make_train_step(model, popt, compress_grads=compress)
    steps = 1 if opt == "adamw8bit" else 2
    for i in range(steps):
        batch = _batch(model.cfg, seed=10 + i)
        jst, jm = jstep(jst, _jax(batch))
        st, m = step(st, _torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(st.step) == int(jst.step) == steps
    _assert_state_close(st, jst, opt, compress)


def _assert_state_close(st, jst, opt, compress=False):
    """Params, the optimizer state and the compression residual of a port
    TrainState against JAX's, within the module docstring's tolerances."""
    _assert_tree_close(st.params, jst.params)
    if opt == "adamw":
        _assert_tree_close(st.opt_state, jst.opt_state)
    else:
        for q, s, jq, js in ((st.opt_state.mu_q, st.opt_state.mu_scale,
                              jst.opt_state.mu_q, jst.opt_state.mu_scale),
                             (st.opt_state.nu_q, st.opt_state.nu_scale,
                              jst.opt_state.nu_q, jst.opt_state.nu_scale)):
            for gq, gs, wq, ws in zip(tree_leaves(q), tree_leaves(s),
                                      jax.tree.leaves(jq), jax.tree.leaves(js)):
                assert gq.dtype == torch.int8
                got = adamw._dequantize(gq, gs).numpy()
                want = np.asarray(jadamw._dequantize(wq, ws))
                np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-3,
                                           atol=1e-12)
                assert np.all(np.abs(got - want) <= 1.001 * np.asarray(ws)[..., None]
                              + 1e-12)
    if compress:
        # each residual is at most half a code of its row, so its row's code
        # is at least 2 max |residual|; a code that rounds the other way (the
        # gradients differ in the last bits) moves a residual by one code
        for g, w in zip(tree_leaves(st.comp_state), jax.tree.leaves(jst.comp_state)):
            w = np.asarray(w)
            diff = np.abs(g.numpy() - w)
            code = 2 * np.abs(w).max(axis=-1, keepdims=True)
            assert np.all(diff <= 1.01 * code + 1e-6)
            assert np.mean(diff > 1e-4) < 0.01


def test_quantize_codes_bit_for_bit():
    """Identical float32 rows, with exact ties (x / scale = k + 0.5) that
    round half to even."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 5, 33)) * 10 ** rng.uniform(-8, 2, (6, 5, 1)))
    x = x.astype(np.float32)
    x[0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    x[1, 1] = 0.0
    q, s = adamw._quantize(torch.from_numpy(x))
    jq, js = jadamw._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 0, :6].tolist() == [127, 0, 2, 2, -2, 0]


def test_schedules_vs_jax():
    steps = list(range(0, 40, 3)) + [5, 6, 100]
    pairs = ((schedules.warmup_cosine(3e-4, 5, 30), jschedules.warmup_cosine(3e-4, 5, 30)),
             (schedules.warmup_cosine(1e-3, 0, 10, 0.2),
              jschedules.warmup_cosine(1e-3, 0, 10, 0.2)),
             (schedules.constant(2e-4), jschedules.constant(2e-4)))
    for got_fn, want_fn in pairs:
        for s in steps:
            got = got_fn(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want_fn(jnp.int32(s))), rtol=1e-6)


def test_corpus_bytes_and_reads_vs_jax(tmp_path):
    rng = np.random.default_rng(4)
    records = [rng.integers(0, 1 << 20, (int(rng.integers(1, 50)), 2)).astype(np.int32)
               for _ in range(5)] + [rng.standard_normal((3, 4)).astype(np.float32)]
    assert pipeline.write_corpus(tmp_path / "port.rec", records) == 6
    jpipeline.write_corpus(tmp_path / "jax.rec", records)
    assert (tmp_path / "port.rec").read_bytes() == (tmp_path / "jax.rec").read_bytes()
    with pipeline.ArrayRecordCorpus(tmp_path / "jax.rec") as corpus:
        assert len(corpus) == 6
        for got, want in zip(corpus, records):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        np.testing.assert_array_equal(corpus.read([3])[0], records[3])
    raw = bytearray((tmp_path / "port.rec").read_bytes())
    raw[-1] ^= 0xFF
    (tmp_path / "bad.rec").write_bytes(bytes(raw))
    with pipeline.ArrayRecordCorpus(tmp_path / "bad.rec") as corpus:
        with pytest.raises(ValueError, match="CRC"):
            corpus[5]


def test_token_batches_vs_jax():
    for kw in (dict(num_hosts=1, host_id=0, seed=0), dict(num_hosts=2, host_id=1, seed=5)):
        got = pipeline.token_batches(8, 12, 300, **kw)
        want = jpipeline.token_batches(8, 12, 300, **kw)
        for _ in range(3):
            a, b = next(got), next(want)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_jax_train_checkpoint_resumes_in_the_port(tmp_path):
    """A TrainState that JAX's CheckpointManager wrote after one step
    restores into the port's TrainState (AdamWState of mu and nu in the
    same leaf order), and the port's next step equals JAX's."""
    jmodel, jparams, model, params = _models("llama3_2_3b")
    sched = (jschedules.warmup_cosine(1e-3, 1, 4), schedules.warmup_cosine(1e-3, 1, 4))
    jopt, popt = jadamw.adamw(sched[0]), adamw.adamw(sched[1])
    jst, jstep = _jax_step(jmodel, jopt, jparams, None)
    jst, _ = jstep(jst, _jax(_batch(model.cfg, seed=20)))
    mgr = JCheckpointManager(tmp_path)
    mgr.save(1, jst, block=True)
    mgr.close()
    template = _port_state(model, popt, tree_map(torch.zeros_like, params))
    pmgr = CheckpointManager(tmp_path)
    st = pmgr.restore(template, device="cpu")
    pmgr.close()
    assert isinstance(st.opt_state, adamw.AdamWState) and int(st.step) == 1
    _assert_tree_close(st.params, jst.params, rtol=0, atol=0)
    batch = _batch(model.cfg, seed=21)
    jst, _ = jstep(jst, _jax(batch))
    st, _ = loop.make_train_step(model, popt)(st, _torch(batch))
    _assert_tree_close(st.params, jst.params)
    _assert_tree_close(st.opt_state, jst.opt_state)


def test_launch_train_main_resumes(tmp_path, capsys):
    """The launcher on a REDUCED config: 3 steps with a checkpoint, then a
    second run resumes at step 3 and ends at 5."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--arch", "llama3.2-3b", "--reduced", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt", str(tmp_path)]
    state = train.main(argv + ["--steps", "3"])
    assert int(state.step) == 3
    assert CheckpointManager(tmp_path).latest_step() == 3
    state = train.main(argv + ["--steps", "5"])
    out = capsys.readouterr().out
    assert int(state.step) == 5 and "finished at step 5" in out
    assert "step      3 loss" in out and "step      0 loss" in out
    assert all(torch.isfinite(t).all() for t in tree_leaves(state.params))


def test_launch_train_whisper_batches():
    """synthetic_batches for whisper: Zipf tokens below the vocab, the
    labels shifted by one, frames [B, encoder_len, d_model], the same every
    batch."""
    from repro_torch.launch.train import synthetic_batches
    cfg = configs.get_reduced("whisper-base")
    it = synthetic_batches(cfg, 3, 10, seed=2)
    a, b = next(it), next(it)
    assert a["tokens"].shape == (3, 10) and int(a["tokens"].max()) < cfg.vocab
    assert torch.equal(a["frames"], b["frames"])
    assert a["frames"].shape == (3, cfg.encoder_len, cfg.d_model)
    assert not torch.equal(a["tokens"], b["tokens"])


def test_make_eval_step_is_the_loss():
    _, _, model, params = _models("whisper_base")
    batch = _torch(_batch(model.cfg, seed=30))
    got = loop.make_eval_step(model)(params, batch)
    want, _ = model.loss_fn(params, batch)
    assert float(got["loss"]) == float(want) and not got["loss"].requires_grad


def test_configs_carry_the_trainer_fields():
    """max_lr and the optimizer (jamba's adamw8bit) are the JAX configs'."""
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        want = importlib.import_module(f"repro.configs.{arch}").CONFIG
        assert (cfg.max_lr, cfg.optimizer) == (want.max_lr, want.optimizer)
    assert configs.get_reduced("jamba-1.5-large-398b").optimizer == "adamw8bit"


def test_serve_cli_restores_params_from_ckpt(tmp_path, monkeypatch, capsys):
    """launch.serve --ckpt: the engine serves the params of the directory's
    newest checkpoint (here another seed's), not the random init."""
    from repro_torch.launch import serve
    model = zoo.build(configs.get_reduced("whisper-base"), device="cpu")
    saved = model.init_params(model.generator(7))
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, saved, block=True)
    mgr.close()
    seen = []

    class Recording(serve.DecodeEngine):
        def __init__(self, model, params, **kw):
            seen.append(params)
            super().__init__(model, params, **kw)

    monkeypatch.setattr(serve, "DecodeEngine", Recording)
    serve.main(["--device", "cpu", "--arch", "whisper-base", "--requests", "1",
                "--max-new", "2", "--ckpt", str(tmp_path)])
    assert "served 1 requests / 2 tokens" in capsys.readouterr().out
    for got, want in zip(tree_leaves(seen[0]), tree_leaves(saved)):
        assert torch.equal(got, want)
