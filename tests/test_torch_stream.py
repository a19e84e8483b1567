"""Parity of the port's lane-batched executor and ``StreamEngine`` with the
JAX package, on the CPU.

The port gives the chunk step an explicit leading lanes axis where the
JAX package vmaps ``scan_chunks``.  The same seeded numpy streams go
through both: the lane helpers (``stack_states``, ``take_lanes``,
``put_lanes``), ``scan_lanes`` against ``jax.vmap(res.scan_chunks)``,
``make_multistream_executor`` for HISTO, HLL, HHD and PageRank (online and
planned, ragged masks, all-masked pad lanes, per-lane re-scheduling at
threshold > 0), each lane against its stream alone through the port's
``make_executor``, and ``StreamEngine`` against JAX's on the same submits.
Every app keeps int32 state: buffers and every ``ExecStats`` field must
match bit for bit.  Small sizes: M = 4, X = 2, chunks of 64 tuples, 3 or 4
lanes.  The lane-batched helpers of the core are also held against their
1-D versions lane by lane, and every PrePE against a [L, T, 2] chunk.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import hhd as jhhd
from repro.apps import histo as jhisto
from repro.apps import hll as jhll
from repro.apps import pagerank as jpagerank
from repro.core import executor as jexecutor
from repro.serve import StreamEngine as JStreamEngine
from repro_torch import interop
from repro_torch.apps import dp, hhd, histo, hll, pagerank
from repro_torch.core import executor, mapper, merger, profiler, scheduler
from repro_torch.core.types import ExecStats
from repro_torch.data.zipf import evolving_zipf_tuples, zipf_tuples
from repro_torch.serve import StreamEngine

M, X, CHUNK = 4, 2, 64
V = 256
APPS = {
    "histo": (lambda: histo.make_spec(64, 1 << 16, M),
              lambda: jhisto.make_spec(64, 1 << 16, M),
              lambda k: histo.oracle(k, 64, 1 << 16, M)),
    "hll": (lambda: hll.make_spec(8, M), lambda: jhll.make_spec(8, M),
            lambda k: hll.oracle(k, 8, M)),
    "hhd": (lambda: hhd.make_spec(4, 64, M), lambda: jhhd.make_spec(4, 64, M),
            lambda k: hhd.oracle(k, 4, 64, M)),
    "pagerank": (lambda: pagerank.make_spec(V, M), lambda: jpagerank.make_spec(V, M),
                 None),
}


def _stream(app, n, alpha, seed):
    """[n, 2] int32 tuples: Zipf keys; PageRank's are <vertex, contribution>."""
    t = zipf_tuples(n, V if app == "pagerank" else 1 << 16, alpha, seed=seed)
    if app == "pagerank":
        t[:, 1] = np.random.default_rng(seed).integers(0, 1 << 12, n)
    return t


def _lanes(app, lanes=4, chunks=6, ragged=True, seed=0, evolving=False):
    """[L, K, CHUNK, 2] tuples and a bool[L, K, CHUNK] mask: lane l at
    alpha 0.75 l with its own seed; ragged tails of different lengths;
    the last lane all masked (a pad lane)."""
    tuples = np.stack([
        evolving_zipf_tuples(chunks * CHUNK, 1 << 16, 1.5, 2 * CHUNK, seed=seed + l)
        if evolving else _stream(app, chunks * CHUNK, 0.75 * l, seed + l)
        for l in range(lanes)]).reshape(lanes, chunks, CHUNK, 2)
    mask = np.ones((lanes, chunks, CHUNK), bool)
    if ragged:
        for l in range(lanes - 1):
            mask[l, -1, CHUNK - 7 * l - 1:] = False
        mask[-1] = False
        tuples[-1] = 0
    return tuples, mask


def _leaves(obj, prefix=""):
    """{path: numpy array} over an ExecState / ExecStats / RoutePlan of
    either package."""
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


def _pair_res(app, threshold=0.0):
    spec, jspec, _ = APPS[app]
    res = executor.make_resumable_executor(spec(), M, X, CHUNK, threshold=threshold,
                                           device="cpu")
    jres = jexecutor.make_resumable_executor(jspec(), M, X, CHUNK, threshold=threshold)
    return res, jres


def _plans(res, tuples, lanes):
    """Per-lane static plans from each lane's first chunk, in both packages."""
    plans, jplans = [], []
    for l in range(lanes):
        dst = res.spec.pre(torch.as_tensor(tuples[l, 0]), M)[0]
        hist = profiler.workload_hist(dst, M).numpy()
        plans.append(executor.make_static_plan(M, X, hist, device="cpu"))
        jplans.append(jexecutor.make_static_plan(M, X, hist))
    return plans, jplans


# ------------------------------------------------------------ lane helpers

def test_stack_take_put_lanes_equal_jax():
    res, jres = _pair_res("histo")
    tuples, mask = _lanes("histo")
    states, _ = res.scan_lanes(executor.stack_states(res.init_state(), 4), tuples, mask)
    jstates, _ = jres.scan_lanes(jexecutor.stack_states(jres.init_state(), 4),
                                 jnp.asarray(tuples), jnp.asarray(mask))
    _tree_eq(executor.stack_states(res.init_state(), 4),
             jexecutor.stack_states(jres.init_state(), 4))
    _tree_eq(states, jstates)
    sub = executor.take_lanes(states, [2, 0])
    jsub = jexecutor.take_lanes(jstates, jnp.asarray([2, 0]))
    _tree_eq(sub, jsub)
    before = _leaves(states)
    put = executor.put_lanes(states, [1, 3], sub)
    _tree_eq(put, jexecutor.put_lanes(jstates, jnp.asarray([1, 3]), jsub))
    _tree_eq(states, jstates)                    # put_lanes returned a new state
    assert all(np.array_equal(v, _leaves(states)[k]) for k, v in before.items())
    # the round trip: taking every lane and putting it back is the identity
    _tree_eq(executor.put_lanes(put, [0, 1, 2, 3], executor.take_lanes(put, [0, 1, 2, 3])),
             jexecutor.put_lanes(jstates, jnp.asarray([1, 3]), jsub))


def test_lane_state_moves_between_packages():
    """A JAX lanes-stacked state after 3 chunks, moved into the port lane by
    lane, continues in the port's scan_lanes as JAX's vmapped scan."""
    res, jres = _pair_res("hll")
    tuples, mask = _lanes("hll")
    jmid, _ = jres.scan_lanes(jexecutor.stack_states(jres.init_state(), 4),
                              jnp.asarray(tuples[:, :3]), jnp.asarray(mask[:, :3]))
    jend, jstats = jres.scan_lanes(jmid, jnp.asarray(tuples[:, 3:]), jnp.asarray(mask[:, 3:]))
    mid = interop.state_from_numpy(
        jax.tree.map(np.asarray, dataclasses.asdict(jmid)), device="cpu")
    end, stats = res.scan_lanes(mid, tuples[:, 3:], mask[:, 3:])
    _tree_eq(end, jend)
    _tree_eq(stats, jstats)


# ---------------------------------------------------------------- scan_lanes

@pytest.mark.parametrize("app,threshold", [("histo", 0.0), ("histo", 0.9), ("hll", 0.0),
                                           ("hhd", 0.0), ("pagerank", 0.0)])
def test_scan_lanes_equal_jax_vmap(app, threshold):
    """scan_lanes against jax.vmap(res.scan_chunks): every leaf of the
    state and of the stats; at threshold 0.9 the lanes re-schedule, each
    on its own."""
    res, jres = _pair_res(app, threshold)
    tuples, mask = _lanes(app, chunks=12 if threshold else 6, evolving=threshold > 0)
    states, stats = res.scan_lanes(executor.stack_states(res.init_state(), 4), tuples, mask)
    jstates, jstats = jax.vmap(jres.scan_chunks)(
        jexecutor.stack_states(jres.init_state(), 4), jnp.asarray(tuples), jnp.asarray(mask))
    _tree_eq(states, jstates)
    _tree_eq(stats, jstats)
    assert stats.max_load.shape == (4, tuples.shape[1])
    if threshold:
        fired = stats.rescheduled.sum(dim=1)
        assert int(fired.sum()) > 0 and len(set(fired.tolist())) > 1, fired
    np.testing.assert_array_equal(res.merge_state(states).numpy(),
                                  np.asarray(jax.vmap(jres.merge_state)(jstates)))


def test_scan_lanes_leaves_the_callers_state():
    res, _ = _pair_res("histo")
    tuples, mask = _lanes("histo")
    states = executor.stack_states(res.init_state(), 4)
    before = _leaves(states)
    res.scan_lanes(states, tuples, mask)
    for key, val in _leaves(states).items():
        np.testing.assert_array_equal(val, before[key], err_msg=key)


def test_scan_lanes_checks_its_shapes():
    res, _ = _pair_res("histo")
    tuples, mask = _lanes("histo")
    with pytest.raises(ValueError, match="chunks must be"):
        res.scan_lanes(executor.stack_states(res.init_state(), 3), tuples, mask)
    with pytest.raises(ValueError, match="chunks must be"):
        res.scan_lanes(res.init_state(), tuples[0], mask[0])


# ------------------------------------------------------- multi-stream executor

@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("app", list(APPS))
def test_multistream_equals_jax_and_solo(app, planned):
    """run_streams against JAX's run_streams (ragged masks and a pad lane,
    online or under per-lane static plans), and each lane against its
    stream alone through the port's make_executor."""
    spec, jspec, oracle = APPS[app]
    run = executor.make_multistream_executor(spec(), M, X, CHUNK, device="cpu")
    jrun = jexecutor.make_multistream_executor(jspec(), M, X, CHUNK)
    tuples, mask = _lanes(app, lanes=4)
    plans = jplans = None
    if planned:
        res, _ = _pair_res(app)
        p, jp = _plans(res, tuples, 4)
        plans, jplans = executor.stack_plans(p), jexecutor.stack_plans(jp)
    merged, stats = run(torch.as_tensor(tuples), plans, mask=torch.as_tensor(mask))
    jmerged, jstats = jrun(jnp.asarray(tuples), jplans, mask=jnp.asarray(mask))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    _tree_eq(stats, jstats)
    solo = executor.make_executor(spec(), M, X, CHUNK, device="cpu")
    for l in range(4):
        plan = None if plans is None else executor.take_lanes(plans, l)
        m, s = solo(torch.as_tensor(tuples[l]), plan, mask=torch.as_tensor(mask[l]))
        np.testing.assert_array_equal(merged[l].numpy(), m.numpy())
        for f in dataclasses.fields(ExecStats):
            assert torch.equal(getattr(stats, f.name)[l], getattr(s, f.name)), f.name
        if oracle is not None:
            keys = tuples[l][mask[l]][:, 0]
            np.testing.assert_array_equal(merged[l].numpy(), oracle(keys))
    # the pad lane leaves its state as init_state made it
    assert not merged[-1].any() and not stats.workload[-1].any()


def test_multistream_dense_without_mask_equals_jax():
    spec, jspec, _ = APPS["histo"]
    tuples, _ = _lanes("histo", lanes=3, ragged=False)
    merged, stats = executor.make_multistream_executor(spec(), M, X, CHUNK, device="cpu")(
        tuples)
    jmerged, jstats = jexecutor.make_multistream_executor(jspec(), M, X, CHUNK)(
        jnp.asarray(tuples))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    _tree_eq(stats, jstats)


def test_dp_under_lanes_raises():
    """DP runs under lanes (each lane appends to its own regions; parity in
    tests/test_torch_session.py).  What still raises for a spec with its
    own merge is what no lane layout gives it: a re-merge mid-stream
    (threshold > 0) and secondary session lanes."""
    spec = dp.make_spec(4, M, 64)
    with pytest.raises(ValueError, match="re-merge mid-stream"):
        executor.make_multistream_executor(spec, M, X, CHUNK, threshold=0.5, device="cpu")
    with pytest.raises(ValueError, match="re-merge mid-stream"):
        StreamEngine(spec, num_pri=M, num_sec=X, chunk_size=CHUNK, threshold=0.5,
                     device="cpu")
    from repro_torch.serve import SessionEngine
    with pytest.raises(ValueError, match="secondary_slots=0"):
        SessionEngine(spec, num_pri=M, num_sec=X, chunk_size=CHUNK, secondary_slots=1,
                      device="cpu")
    res = executor.make_resumable_executor(spec, M, X, CHUNK, device="cpu")
    states, _ = res.scan_lanes(executor.stack_states(res.init_state(), 2),
                               np.zeros((2, 1, CHUNK, 2), np.int32))
    assert res.merge_state(states).cursor.shape == (2, M + X)


def test_lane_entry_points_default_to_cuda():
    """Without device="cpu" they raise where there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        executor.make_multistream_executor(histo.make_spec(64, 1 << 16, M), M, X, CHUNK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamEngine(histo.make_spec(64, 1 << 16, M), num_pri=M, num_sec=X, chunk_size=CHUNK)


def test_stack_plans_checks_shapes():
    a = executor.make_static_plan(M, X, np.arange(M), device="cpu")
    b = executor.make_static_plan(M, X + 1, np.arange(M), device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        executor.stack_plans([a, b])
    with pytest.raises(ValueError, match="at least one"):
        executor.stack_plans([])
    stacked = executor.stack_plans([a, a])
    assert stacked.num_pri == M and stacked.num_sec == X
    assert stacked.table.shape == (2, M, X + 1)


# ------------------------------------------------- the core's lane-batched steps

def _per_lane(fn, *args):
    """fn applied lane by lane and stacked."""
    outs = [fn(*(a[l] for a in args)) for l in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def test_core_steps_batch_over_lanes():
    """workload_hist, occurrence_rank, schedule_secpes, post_plan_max_load,
    apply_schedule, redirect, merge_buffers and reset_sec_buffers over a
    leading lanes axis equal their 1-D versions lane by lane."""
    rng = np.random.default_rng(5)
    lanes, t = 3, 50
    dst = torch.as_tensor(rng.integers(0, M + 1, (lanes, t)), dtype=torch.int32)  # M: sentinel
    base = torch.as_tensor(rng.integers(0, 9, (lanes, M)), dtype=torch.int32)
    hist = profiler.workload_hist(dst, M)
    assert torch.equal(hist, _per_lane(lambda d: profiler.workload_hist(d, M), dst))
    rank, new_base = mapper.occurrence_rank(dst, M, base)
    want = _per_lane(lambda d, b: mapper.occurrence_rank(d, M, b), dst, base)
    assert torch.equal(new_base, want[1])
    live = dst < M
    assert torch.equal(rank[live], want[0][live])
    hist = hist.clone()
    hist[1] = hist[1, 0]                         # ties: the first maximum wins
    for x in (0, X, 5):
        a = scheduler.schedule_secpes(hist, x)
        assert torch.equal(a, _per_lane(lambda w: scheduler.schedule_secpes(w, x), hist))
        am = scheduler.schedule_secpes(hist, x, min_load=12)
        assert torch.equal(am, _per_lane(
            lambda w: scheduler.schedule_secpes(w, x, min_load=12), hist))
        assert torch.equal(scheduler.post_plan_max_load(hist.float(), a),
                           _per_lane(scheduler.post_plan_max_load, hist.float(), a))
        plans = executor.stack_plans([mapper.init_plan(M, x, "cpu")] * lanes)
        for assignment in (a, am):
            got = mapper.apply_schedule(plans, assignment)
            for l in range(lanes):
                one = mapper.apply_schedule(mapper.init_plan(M, x, "cpu"), assignment[l])
                _tree_eq(executor.take_lanes(got, l), one)
            eff = mapper.redirect(got, dst, rank)
            for l in range(lanes):
                one = executor.take_lanes(got, l)
                assert torch.equal(eff[l][live[l]],
                                   mapper.redirect(one, dst[l], rank[l])[live[l]])
            for combine in ("add", "max"):
                bufs = torch.as_tensor(rng.integers(-50, 50, (lanes, M + x, 3, 5)),
                                       dtype=torch.int32)
                merged = merger.merge_buffers(bufs, assignment, M, combine)
                assert torch.equal(merged, _per_lane(
                    lambda b, s: merger.merge_buffers(b, s, M, combine), bufs, assignment))
                reset = merger.reset_sec_buffers(bufs, M, combine, pe_axis=1)
                assert torch.equal(reset, _per_lane(
                    lambda b: merger.reset_sec_buffers(b, M, combine), bufs))


@pytest.mark.parametrize("app", ["histo", "hll", "hhd", "pagerank", "dp"])
def test_prepe_takes_a_lanes_axis(app):
    """Every PrePE maps a [L, T, 2] chunk as it maps each [T, 2] lane."""
    spec = dp.make_spec(4, M, 64) if app == "dp" else APPS[app][0]()
    chunk = torch.as_tensor(np.stack([_stream("pagerank" if app == "pagerank" else "histo",
                                              CHUNK, 1.0, s) for s in range(3)]))
    got = spec.pre(chunk, M)
    for l in range(3):
        for g, w in zip(got, spec.pre(chunk[l], M)):
            assert g.dtype == w.dtype and torch.equal(g[l], w)


@pytest.mark.parametrize("app", ["histo", "hhd"])
def test_lane_pe_update_drops_the_sentinel(app):
    """A masked tuple of lane 0 (eff = M+X) must not land in lane 1's
    PriPE 0: the flattened update turns the sentinel into -1 first."""
    spec = APPS[app][0]()
    pe_update = spec.pe_update or (lambda b, e, i, v: executor.default_pe_update(
        b, e, i, v, spec.combine))
    bufs = spec.init_buffer(M + X, "cpu").expand(2, *spec.init_buffer(M + X, "cpu").shape)
    bufs = bufs.contiguous()
    chunk = torch.as_tensor(np.stack([_stream(app, 8, 0.0, s) for s in range(2)]))
    _, idx, value = spec.pre(chunk, M)
    eff = torch.full((2, 8), M + X, dtype=torch.int32)    # every tuple masked
    out = executor._lane_pe_update(pe_update, bufs, eff, idx, value, M + X)
    assert not out.any()
    eff[1] = 0
    out = executor._lane_pe_update(pe_update, bufs, eff, idx, value, M + X)
    assert not out[0].any() and int(out[1, 0].sum()) == 8 * (4 if app == "hhd" else 1)


# --------------------------------------------------------------- StreamEngine

def _engines(app="histo", max_streams=4, **kw):
    spec, jspec, _ = APPS[app]
    return (StreamEngine(spec(), num_pri=M, num_sec=X, chunk_size=CHUNK,
                         max_streams=max_streams, device="cpu", **kw),
            JStreamEngine(jspec(), num_pri=M, num_sec=X, chunk_size=CHUNK,
                          max_streams=max_streams))


def _out_eq(out, jout):
    assert out.keys() == jout.keys()
    for rid, (merged, stats) in jout.items():
        got_merged, got_stats = out[rid]
        assert isinstance(got_merged, np.ndarray)
        np.testing.assert_array_equal(got_merged, np.asarray(merged))
        for f in dataclasses.fields(ExecStats):
            g, w = getattr(got_stats, f.name), np.asarray(getattr(stats, f.name))
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def _oracle(data):
    return APPS["histo"][2](np.asarray(data)[:, 0])


def _case_no_hol_blocking(eng, jeng):
    """A long stream at the head does not hold back the short ones: the
    largest compatible group goes first."""
    long = _stream("histo", 4 * CHUNK, 1.5, 1)
    shorts = [_stream("histo", CHUNK, a, 2 + i) for i, a in enumerate((0.0, 1.0, 2.0))]
    streams = [long] + shorts
    for e in (eng, jeng):
        for s in streams:
            e.submit(s)
    batch, jbatch = eng._next_batch(), jeng._next_batch()
    assert [r.rid for r in batch] == [r.rid for r in jbatch] == [1, 2, 3]
    assert [r.rid for r in eng.pending] == [0]
    eng.pending, jeng.pending = batch + eng.pending, jbatch + jeng.pending
    return streams


def _case_pad_lane_isolation(eng, jeng):
    """One tenant in a batch of 4: three all-masked pad lanes."""
    data = _stream("histo", 2 * CHUNK, 2.0, 0)
    for e in (eng, jeng):
        e.submit(data)
    return [data]


def _case_ragged_submit(eng, jeng):
    """Streams of any length: the tail is a masked final chunk."""
    streams = [_stream("histo", CHUNK + 23, 1.5, 0), _stream("histo", CHUNK + 50, 0.5, 1)]
    for e in (eng, jeng):
        for s in streams:
            e.submit(s)
    return streams


def _case_flush_order(eng, jeng):
    """Submission order changes no tenant's result (here: reversed)."""
    streams = [_stream("histo", CHUNK * (1 + i % 2), 0.5 * i, 10 + i) for i in range(5)]
    for e in (eng, jeng):
        for s in reversed(streams):
            e.submit(s)
    return streams[::-1]


@pytest.mark.parametrize("case", [_case_no_hol_blocking, _case_pad_lane_isolation,
                                  _case_ragged_submit, _case_flush_order],
                         ids=["no_hol_blocking", "pad_lane_isolation", "ragged_submit",
                              "flush_order"])
def test_stream_engine_equals_jax(case):
    eng, jeng = _engines()
    streams = case(eng, jeng)
    out, jout = eng.flush(), jeng.flush()
    assert not eng.pending and not jeng.pending
    _out_eq(out, jout)
    for rid, data in enumerate(streams):
        np.testing.assert_array_equal(out[rid][0], _oracle(data))
        assert out[rid][1].modeled_cycles.shape == (-(-len(data) // CHUNK),)


@pytest.mark.parametrize("app", ["hll", "hhd", "pagerank"])
def test_stream_engine_other_apps_equal_jax(app):
    eng, jeng = _engines(app, max_streams=3)
    for i in range(4):
        data = _stream(app, CHUNK * 2 + 9 * i, 1.0 + i, 20 + i)
        for e in (eng, jeng):
            e.submit(data)
    _out_eq(eng.flush(), jeng.flush())


def test_stream_engine_per_tenant_plans_equal_jax():
    """Planned tenants (a RoutePlan each, or a TunedPlan) batch apart from
    online ones; every result equals JAX's."""
    from repro.tune import autotune_from_workload as jtune
    from repro_torch.tune import autotune_from_workload as tune
    eng, jeng = _engines()
    res, _ = _pair_res("histo")
    for i in range(3):
        data = _stream("histo", CHUNK * 3 - 5 * i, 2.0, 30 + i)
        chunks = data[:CHUNK * 2].reshape(2, CHUNK, 2)
        (plan,), (jplan,) = _plans(res, chunks[None], 1)
        eng.submit(data, plan=plan)
        jeng.submit(data, plan=jplan)
        eng.submit(data[::-1].copy())
        jeng.submit(data[::-1].copy())
    _out_eq(eng.flush(), jeng.flush())
    spec, jspec, _ = APPS["histo"]
    hist = profiler.workload_hist(res.spec.pre(torch.as_tensor(
        _stream("histo", 4 * CHUNK, 2.0, 9)), M)[0], M).numpy()
    tuned, jtuned = tune(spec(), hist, device="cpu"), jtune(jspec(), hist)
    assert (tuned.num_pri, tuned.num_sec, tuned.chunk_size) == \
        (jtuned.num_pri, jtuned.num_sec, jtuned.chunk_size)
    eng = StreamEngine(spec(), tuned=tuned, max_streams=2, device="cpu")
    jeng = JStreamEngine(jspec(), tuned=jtuned, max_streams=2)
    data = _stream("histo", 3 * tuned.chunk_size + 1, 2.0, 40)
    for e, t in ((eng, tuned), (jeng, jtuned)):
        e.submit(data, plan=t)
        e.submit(data[:2 * t.chunk_size])
    _out_eq(eng.flush(), jeng.flush())
    with pytest.raises(ValueError, match="engine runs"):
        eng.submit(data, plan=executor.make_static_plan(M + 1, 0, np.ones(M + 1),
                                                        device="cpu"))


def test_stream_engine_metrics_and_spans():
    """stream_requests_total, stream_batches_total, flush_latency_ms
    {scope="stream"} and the stream.flush / stream.batch spans, as JAX's."""
    from repro_torch import obs as obs_lib
    from repro_torch.obs.metrics import parse_prometheus
    o = obs_lib.Observability()
    eng = StreamEngine(APPS["histo"][0](), num_pri=M, num_sec=X, chunk_size=CHUNK,
                       max_streams=2, device="cpu", obs=o)
    for i in range(3):
        eng.submit(_stream("histo", CHUNK * (1 + i), 1.0, i))
    eng.flush()
    samples = {(name, tuple(sorted(labels.items()))): value
               for name, labels, value in parse_prometheus(o.registry.prometheus_text())}
    assert samples[("stream_requests_total", ())] == 3.0
    assert samples[("stream_batches_total", ())] == 3.0
    assert samples[("flush_latency_ms_count", (("scope", "stream"),))] == 1.0
    names = [e["name"] for e in o.tracer.events()]
    assert names.count("stream.flush") == 1 and names.count("stream.batch") == 3
