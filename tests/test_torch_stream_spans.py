"""The spans of the port's stream path (``StreamEngine.flush`` down to the
chunk step's stages), on the CPU.

A flush is one span tree on the engine's thread::

    stream.flush
      stream.batch (rids)
        stream.stack, executor.load,
        executor.step x K (executor.route, executor.pe_update,
                           [executor.plan,] executor.schedule),
        executor.finish, stream.drain, stream.collect

A step has ``executor.plan`` only where a lane can still take a plan:
here, with one chunk of profiling, the batch's first step.

Only a bundle handed to the engine or an executor factory gets spans; the
outputs are the same bit for bit with the tracer on, off and under
``torch.profiler``; a span entered under a recording profiler is also a
profiler range of its name, and with no profiler running none is entered.
"""
import dataclasses

import numpy as np
import pytest
from torch.autograd import profiler as torch_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs as obs_lib
from repro_torch.apps import histo
from repro_torch.core import executor
from repro_torch.core.types import ExecStats
from repro_torch.data.zipf import zipf_tuples
from repro_torch.serve import StreamEngine

M, X, CHUNK, LANES = 4, 2, 64, 4
LENGTHS = (190, 170, 150)            # 3 chunks each, every tail ragged; one pad lane
BATCH_CHILDREN = ["stream.stack", "executor.load", "executor.step", "executor.finish",
                  "stream.drain", "stream.collect"]
STAGES = ["executor.route", "executor.pe_update", "executor.schedule"]
PLAN = "executor.plan"               # the stage of a step that can still take a plan
SPANS = ["stream.flush", "stream.batch", *BATCH_CHILDREN, *STAGES, PLAN]
# an aten op each stage runs on the CPU
STAGE_OPS = {"executor.load": "aten::stack", "executor.route": "aten::cumsum",
             "executor.pe_update": "aten::index_add_", "executor.plan": "aten::argmax",
             "executor.schedule": "aten::amax", "executor.finish": "aten::stack"}


def _spec():
    return histo.make_spec(64, 1 << 16, M)


def _engine(obs):
    eng = StreamEngine(_spec(), num_pri=M, num_sec=X, chunk_size=CHUNK,
                       max_streams=LANES, device="cpu", obs=obs)
    for i, n in enumerate(LENGTHS):
        eng.submit(zipf_tuples(n, 1 << 16, 0.5 + i, seed=i))
    return eng


def _events(o, name=None):
    return [e for e in o.tracer.events() if name is None or e["name"] == name]


def _inside(child, parent, slack_us=2):
    """Time containment on one thread, to the tracer's microsecond."""
    return child["tid"] == parent["tid"] and child["ts"] >= parent["ts"] - slack_us \
        and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + slack_us


def test_a_flush_is_one_span_tree():
    o = obs_lib.Observability()
    eng = _engine(o)
    rids = [r.rid for r in eng.pending]
    eng.flush()
    ev = _events(o)
    assert len({e["tid"] for e in ev}) == 1
    (flush,) = _events(o, "stream.flush")
    (batch,) = _events(o, "stream.batch")
    assert batch["args"] == {"size": 3, "chunks": 3, "rids": rids}
    assert _inside(batch, flush)
    children = sorted((e for e in ev if e["name"] in BATCH_CHILDREN),
                      key=lambda e: e["ts"])
    assert [e["name"] for e in children] == \
        ["stream.stack", "executor.load", *["executor.step"] * 3, "executor.finish",
         "stream.drain", "stream.collect"]
    for a, b in zip(children, children[1:]):
        assert _inside(a, batch) and a["ts"] + a["dur"] <= b["ts"] + 1
    assert {e["name"] for e in ev} == set(SPANS)


def test_one_step_span_a_batched_chunk_with_one_span_a_stage():
    o = obs_lib.Observability()
    eng = _engine(o)
    eng.flush()
    steps = _events(o, "executor.step")
    assert len(steps) == 3                       # 3 batched chunks
    for stage in STAGES:
        spans = _events(o, stage)
        assert len(spans) == len(steps)
        for step in steps:
            assert sum(_inside(s, step) for s in spans) == 1, (stage, step)
    for step in steps:
        route, update, sched = (next(s for s in _events(o, n) if _inside(s, step))
                                for n in STAGES)
        assert route["ts"] <= update["ts"] <= sched["ts"]
    # the plan stage: the first step only, between the update and the schedule
    (plan,) = _events(o, PLAN)
    first = min(steps, key=lambda e: e["ts"])
    assert _inside(plan, first)
    update, sched = (next(s for s in _events(o, n) if _inside(s, first))
                     for n in STAGES[1:])
    assert update["ts"] <= plan["ts"] <= sched["ts"]


@pytest.mark.parametrize("static_plan", [False, True])
def test_run_chunks_and_scan_lanes_span_their_steps(static_plan):
    """The stage spans live in the chunk step: every executor shape gets
    them; a static-plan step's schedule span holds only its stats, and it
    has no plan stage; an online call's first step has one."""
    o = obs_lib.Observability()
    res = executor.make_resumable_executor(_spec(), M, X, CHUNK, device="cpu",
                                           static_plan=static_plan, obs=o)
    data = zipf_tuples(4 * CHUNK, 1 << 16, 2.0, seed=7).reshape(4, CHUNK, 2)
    res.run_chunks(res.init_state(), data)
    res.scan_lanes(executor.stack_states(res.init_state(), 2), np.stack([data, data]))
    names = [e["name"] for e in _events(o)]
    assert names.count("executor.step") == 8
    assert all(names.count(s) == 8 for s in STAGES)
    assert names.count(PLAN) == (0 if static_plan else 2)
    assert set(names) == {"executor.step", *STAGES} | (set() if static_plan else {PLAN})


def test_no_bundle_no_spans():
    """StreamEngine(obs=False) and an executor without obs= emit no span
    into any bundle, the process default included."""
    default = obs_lib.get_default()
    before = len(_events(default))
    off = obs_lib.Observability(enabled=False)
    eng = _engine(off)
    eng.flush()
    assert not _events(off)
    run = executor.make_multistream_executor(_spec(), M, X, CHUNK, device="cpu")
    data = zipf_tuples(2 * CHUNK, 1 << 16, 1.0, seed=3).reshape(1, 2, CHUNK, 2)
    run(np.concatenate([data, data]))
    executor.make_executor(_spec(), M, X, CHUNK, device="cpu")(data[0])
    assert len(_events(default)) == before


def _flat(out):
    return {rid: (merged, {f.name: getattr(st, f.name) for f in dataclasses.fields(ExecStats)})
            for rid, (merged, st) in out.items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for rid in a:
        assert np.array_equal(a[rid][0], b[rid][0]) and a[rid][0].dtype == b[rid][0].dtype
        for name, v in a[rid][1].items():
            w = b[rid][1][name]
            assert np.array_equal(v, w) and v.dtype == w.dtype, (rid, name)


def test_outputs_bit_exact_with_the_tracer_on_off_and_under_the_profiler():
    on = _flat(_engine(obs_lib.Observability()).flush())
    off = _flat(_engine(obs_lib.Observability(enabled=False)).flush())
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _flat(_engine(obs_lib.Observability()).flush())
    _assert_same(on, off)
    _assert_same(on, profiled)


def test_spans_are_profiler_ranges_holding_their_stages_ops():
    o = obs_lib.Observability()
    eng = _engine(o)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.flush()
    events = list(prof.events())
    names = {e.name for e in events}
    assert set(SPANS) <= names
    aten = [e for e in events if e.name.startswith("aten::")]
    for span, op in STAGE_OPS.items():
        ranges = [e for e in events if e.name == span]
        for r in ranges:
            inside = {e.name for e in aten if r.time_range.start <= e.time_range.start
                      and e.time_range.end <= r.time_range.end}
            assert op in inside, (span, sorted(inside))
    # the tracer's own record of the same flush is whole
    assert {e["name"] for e in _events(o)} == set(SPANS)


def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []
    real = torch_profiler.record_function

    def counting(name, *args, **kw):
        entered.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch_profiler, "record_function", counting)
    o = obs_lib.Observability()
    _engine(o).flush()
    assert _events(o) and entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _engine(obs_lib.Observability(enabled=False)).flush()   # off: no range
        assert entered == []
        _engine(o).flush()
    assert sorted(set(entered)) == sorted(SPANS)
    assert entered.count("executor.step") == 3


def test_a_spans_range_closes_when_its_body_raises():
    """Under the profiler a span and its nested spans are ranges that end
    with them, a raising body included, and the ring records them all; a
    disabled tracer's spans are neither."""
    o = obs_lib.Observability()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(KeyError):
            with o.span("outer", cat="c", k=1):
                with o.span("inner", cat="c"):
                    raise KeyError("x")
        with o.span("after", cat="c"):
            pass
    ranges = {e.name: e for e in prof.events() if e.name in ("outer", "inner", "after")}
    assert set(ranges) == {"outer", "inner", "after"}
    assert ranges["inner"].time_range.end <= ranges["outer"].time_range.end \
        <= ranges["after"].time_range.start
    inner, outer, after = _events(o)
    assert [inner["name"], outer["name"], after["name"]] == ["inner", "outer", "after"]
    assert outer["args"] == {"k": 1} and _inside(inner, outer)
    off = obs_lib.Observability(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off.span("outer"):
            pass
    assert not _events(off) and "outer" not in {e.name for e in prof.events()}


def test_stages_record_what_nested_spans_record():
    """A staged span gives the events of a span with one nested span a
    stage (names, cats, args, containment), ranges under the profiler,
    and its events when its body raises."""
    staged, nested = obs_lib.Observability(), obs_lib.Observability()
    with staged.tracer.stages("outer", cat="c") as stage:
        stage("a")
        stage("b")
    with nested.span("outer", cat="c"):
        with nested.span("a", cat="c"):
            pass
        with nested.span("b", cat="c"):
            pass
    got, want = _events(staged), _events(nested)
    keep = ("name", "ph", "cat", "pid", "tid", "args")
    assert [{k: e[k] for k in keep} for e in got] == [{k: e[k] for k in keep} for e in want]
    outer = got[-1]
    assert all(_inside(e, outer) for e in got[:-1]) and got[0]["ts"] <= got[1]["ts"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with staged.tracer.stages("outer2", cat="c") as stage:
            stage("a2")
            stage("b2")
    assert {"outer2", "a2", "b2"} <= {e.name for e in prof.events()}
    with pytest.raises(KeyError):
        with staged.tracer.stages("outer3") as stage:
            stage("a3")
            raise KeyError("x")
    assert [e["name"] for e in _events(staged)][-2:] == ["a3", "outer3"]
    off = obs_lib.Observability(enabled=False)
    with off.tracer.stages("outer") as stage:
        stage("a")
    assert not _events(off)
