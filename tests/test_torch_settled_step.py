"""The settled chunk step against the JAX package's executor, on the CPU.

The executor's loops (``run_chunks``, ``scan_lanes``, the multi-stream
executor and ``StreamEngine`` on top of them) skip the SecPE plan's
generation on a step where no lane can take a plan or re-schedule:
threshold 0, no static plan, and every lane either not live at the step or
past ``profile_chunks`` live steps earlier in the call (under threshold 0
no step builds the re-schedule block).
Each case holds the port bit-exact against JAX's full step (merged buffers,
every ``ExecStats`` field, the final ``ExecState``) and counts the steps
that ran the full step by their ``executor.plan`` spans, against the rule
computed here step by step.  Small sizes: M = 4, X = 2, chunks of 64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import histo as jhisto
from repro.core import executor as jexecutor
from repro.serve import StreamEngine as JStreamEngine
from repro_torch import obs as obs_lib
from repro_torch.apps import histo
from repro_torch.core import executor, profiler
from repro_torch.core.types import ExecStats
from repro_torch.data.zipf import evolving_zipf_tuples, zipf_tuples
from repro_torch.serve import StreamEngine

M, X, CHUNK, DOMAIN = 4, 2, 64, 1 << 16
PLAN = "executor.plan"


def _spec():
    return histo.make_spec(64, DOMAIN, M)


def _jspec():
    return jhisto.make_spec(64, DOMAIN, M)


def _pair(profile_chunks=1, threshold=0.0):
    """The port's resumable executor with a span bundle, and JAX's."""
    o = obs_lib.Observability()
    res = executor.make_resumable_executor(_spec(), M, X, CHUNK, device="cpu", obs=o,
                                           profile_chunks=profile_chunks,
                                           threshold=threshold)
    jres = jexecutor.make_resumable_executor(_jspec(), M, X, CHUNK,
                                             profile_chunks=profile_chunks,
                                             threshold=threshold)
    return res, jres, o


def _plans(o):
    return sum(e["name"] == PLAN for e in o.tracer.events())


def _full_steps(live, profile_chunks, threshold=0.0):
    """The rule, step by step: live bool[L, K] -> how many of the K steps
    run the full step (a plan span each)."""
    if threshold > 0.0:
        return live.shape[1]
    seen = np.zeros(live.shape[0], int)
    full = 0
    for k in range(live.shape[1]):
        full += not all(not live[l, k] or seen[l] >= max(profile_chunks, 1)
                        for l in range(live.shape[0]))
        seen += live[:, k]
    return full


def _lanes(lanes, chunks, seed=0, evolving=False):
    """[L, K, CHUNK, 2] tuples, lane l at alpha 0.75 l (or evolving skew)."""
    return np.stack([
        evolving_zipf_tuples(chunks * CHUNK, DOMAIN, 1.5, 2 * CHUNK, seed=seed + l)
        if evolving else zipf_tuples(chunks * CHUNK, DOMAIN, 0.75 * l, seed=seed + l)
        for l in range(lanes)]).reshape(lanes, chunks, CHUNK, 2)


def _leaves(obj, prefix=""):
    """{path: numpy array} over an ExecState / ExecStats of either package."""
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_leaves(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: obj.numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)}


def _tree_eq(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key, val in want.items():
        assert got[key].dtype == val.dtype, (key, got[key].dtype, val.dtype)
        np.testing.assert_array_equal(got[key], val, err_msg=key)


def _scan_eq(res, jres, states, jstates, tuples, mask):
    """scan_lanes in both packages from the given states: the final states,
    the stats and the merged buffers equal, bit for bit."""
    got, stats = res.scan_lanes(states, tuples, mask)
    want, jstats = jres.scan_lanes(jstates, jnp.asarray(tuples),
                                   None if mask is None else jnp.asarray(mask))
    _tree_eq(got, want)
    _tree_eq(stats, jstats)
    np.testing.assert_array_equal(res.merge_state(got).numpy(),
                                  np.asarray(jax.vmap(jres.merge_state)(want)))
    return got, want


@pytest.mark.parametrize("profile_chunks", [1, 3])
def test_dense_chunks_settle_after_profile_chunks(profile_chunks):
    """mask=None: the first ``profile_chunks`` steps of each call are full,
    in run_chunks and in scan_lanes."""
    res, jres, o = _pair(profile_chunks)
    tuples = _lanes(3, 8)
    state, stats = res.run_chunks(res.init_state(), tuples[2])
    jstate, jstats = jres.run_chunks(jres.init_state(), jnp.asarray(tuples[2]))
    _tree_eq(state, jstate)
    _tree_eq(stats, jstats)
    np.testing.assert_array_equal(res.merge_state(state).numpy(),
                                  np.asarray(jres.merge_state(jstate)))
    assert _plans(o) == _full_steps(np.ones((1, 8), bool), profile_chunks) \
        == profile_chunks
    o.tracer.clear()
    _scan_eq(res, jres, executor.stack_states(res.init_state(), 3),
             jexecutor.stack_states(jres.init_state(), 3), tuples, None)
    assert _plans(o) == profile_chunks
    assert int(stats.mode[profile_chunks - 1]) == 0 and bool((stats.mode[profile_chunks:]
                                                                == 1).all())


def test_stream_engine_flush_with_ragged_streams_and_pad_lanes():
    """A StreamEngine flush of ragged streams padded with all-masked lanes
    equals JAX's engine; one full step a batch (its first)."""
    o = obs_lib.Observability()
    eng = StreamEngine(_spec(), num_pri=M, num_sec=X, chunk_size=CHUNK, max_streams=4,
                       device="cpu", obs=o)
    jeng = JStreamEngine(_jspec(), num_pri=M, num_sec=X, chunk_size=CHUNK, max_streams=4)
    streams = [zipf_tuples(5 * CHUNK - 7 * i - 1, DOMAIN, 0.5 + i, seed=i) for i in range(3)]
    streams.append(zipf_tuples(2 * CHUNK + 5, DOMAIN, 2.5, seed=9))   # a batch of its own
    for e in (eng, jeng):
        for s in streams:
            e.submit(s)
    out, jout = eng.flush(), jeng.flush()
    assert out.keys() == jout.keys() == set(range(4))
    for rid, (merged, stats) in jout.items():
        np.testing.assert_array_equal(out[rid][0], np.asarray(merged))
        np.testing.assert_array_equal(out[rid][0],
                                      histo.oracle(streams[rid][:, 0], 64, DOMAIN, M))
        for f in dataclasses.fields(ExecStats):
            g, w = getattr(out[rid][1], f.name), np.asarray(getattr(stats, f.name))
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    # batches of 5 and 3 chunks, every lane's first chunk live or a pad lane
    live = [np.array([[True] * k] * n + [[False] * k] * (4 - n)) for k, n in ((5, 3), (3, 1))]
    assert _plans(o) == sum(_full_steps(lv, 1) for lv in live) == 2


@pytest.mark.parametrize("profile_chunks", [1, 2])
def test_lanes_whose_first_chunks_are_masked(profile_chunks):
    """A lane whose first chunks are fully masked starts its profiling late:
    the steps stay full until its own window has passed."""
    res, jres, o = _pair(profile_chunks)
    tuples = _lanes(4, 7, seed=3)
    mask = np.ones((4, 7, CHUNK), bool)
    mask[0, :3] = False             # lane 0 live from step 3
    mask[1, 0] = False              # lane 1 from step 1
    mask[2, 4] = False              # lane 2 skips one chunk later on
    mask[3, -1, CHUNK // 2:] = False
    _scan_eq(res, jres, executor.stack_states(res.init_state(), 4),
             jexecutor.stack_states(jres.init_state(), 4), tuples, mask)
    # P = 1: steps 0, 1 and 3 (each lane's first live step); P = 2 also 2 and 4
    want = _full_steps(mask.any(-1), profile_chunks)
    assert want == {1: 3, 2: 5}[profile_chunks] and _plans(o) == want


def test_a_state_resumed_mid_profile():
    """Two scan_lanes calls, the first shorter than profile_chunks: the
    second call resumes every lane in PROFILE and counts its live steps
    anew, so its first profile_chunks steps are full."""
    res, jres, o = _pair(profile_chunks=3)
    tuples = _lanes(3, 8, seed=5)
    mask = np.ones((3, 8, CHUNK), bool)
    mask[1, 3] = False
    mid, jmid = _scan_eq(res, jres, executor.stack_states(res.init_state(), 3),
                         jexecutor.stack_states(jres.init_state(), 3),
                         tuples[:, :2], mask[:, :2])
    assert _plans(o) == 2 and bool((mid.mode == 0).all())
    o.tracer.clear()
    _scan_eq(res, jres, mid, jmid, tuples[:, 2:], mask[:, 2:])
    assert _plans(o) == _full_steps(mask[:, 2:].any(-1), 3) == 4


def test_lanes_started_with_a_plan():
    """Lanes started in RUN mode under their own plans: only each call's
    first step is full; the monitor keeps updating on the settled ones."""
    res, jres, o = _pair()
    tuples = _lanes(3, 6, seed=11)
    plans, jplans = [], []
    for l in range(3):
        dst = res.spec.pre(torch.as_tensor(tuples[l, 0]), M)[0]
        hist = profiler.workload_hist(dst, M).numpy()
        plans.append(executor.make_static_plan(M, X, hist, device="cpu"))
        jplans.append(jexecutor.make_static_plan(M, X, hist))
    states = executor.with_plan(executor.stack_states(res.init_state(), 3),
                                executor.stack_plans(plans))
    jstates = jexecutor.stack_states(jres.init_state(), 3)
    jstates = dataclasses.replace(jstates, plan=jexecutor.stack_plans(jplans),
                                  mode=jnp.ones((3,), jnp.int32))
    got, _ = _scan_eq(res, jres, states, jstates, tuples, None)
    assert _plans(o) == 1
    assert bool((got.monitor.ema_cycles > 0).all())


def test_threshold_runs_the_full_step_every_time():
    """threshold > 0: any step may re-schedule, so every step is full."""
    res, jres, o = _pair(threshold=0.5)
    tuples = _lanes(3, 10, seed=2, evolving=True)
    _scan_eq(res, jres, executor.stack_states(res.init_state(), 3),
             jexecutor.stack_states(jres.init_state(), 3), tuples, None)
    assert _plans(o) == _full_steps(np.ones((3, 10), bool), 1, threshold=0.5) == 10


def test_settled_steps_match_the_full_step_and_a_direct_step_is_full():
    """The loops' settled steps return what the full step returns, leaf for
    leaf; ``step`` called directly always runs the full step."""
    res, _, o = _pair()
    tuples = _lanes(3, 5, seed=7)
    mask = np.ones((3, 5, CHUNK), bool)
    mask[2, 1:3] = False
    got, stats = res.scan_lanes(executor.stack_states(res.init_state(), 3), tuples, mask)
    assert _plans(o) == 1
    o.tracer.clear()
    state, full = executor.stack_states(res.init_state(), 3), []
    for k in range(5):
        state, s = res.step(state, torch.as_tensor(tuples[:, k]), torch.as_tensor(mask[:, k]))
        full.append(s)
    assert _plans(o) == 5
    _tree_eq(got, state)
    _tree_eq(stats, executor._stack_stats(full, state, M))


def test_the_rule_reads_no_mask_off_the_host():
    """A mask on another device than the CPU gives no host facts: no step
    settles, and nothing is read back."""
    mask = torch.ones((2, 6, CHUNK), dtype=torch.bool, device="meta")
    assert executor._settled_steps(1, mask, 2, 6) == [False] * 6
    host = np.ones((2, 6, CHUNK), bool)
    assert executor._settled_steps(1, host, 2, 6) == [False] + [True] * 5
    assert executor._settled_steps(1, torch.as_tensor(host[0]), 0, 6) == [False] + [True] * 5
    assert executor._settled_steps(None, None, 2, 6) == [False] * 6
    assert executor._settled_steps(3, None, 0, 0) == []
