"""Parity of the port's ``SessionEngine`` with the JAX package's, on the CPU.

Every op script goes through ``repro.serve.SessionEngine`` (``mesh=None``)
and ``repro_torch.serve.SessionEngine(device="cpu")`` in lockstep
(``Twin``).  After each op the twin asserts equal answers of ``query`` and
``close`` (bit for bit: HISTO and DP keep int32 state), the same exception
class and message, equal slot tables, queues, free slots, grants, session
stats and flush counters, equal integer telemetry fields and equal
Prometheus series (parsed with the port's ``parse_prometheus``).  Two
things are left out of the comparison because they measure different
things in the two packages: wall-clock milliseconds (the ``*_ms`` fields
and the sums and buckets of the ``*_ms`` histograms), and the build
counters ``n_retraces`` / ``compile_stall_ms`` where an engine has not
warmed up (XLA compiles in JAX, nvcc builds and library loads in the port,
none on the CPU).

The counterparts of ``tests/test_serving.py``'s local classes follow (one-
shot exactness, ragged appends, non-destructive query, per-session flush,
tenant skew scheduling, shape buckets, batched admission, error messages),
then DP under lanes (``scan_lanes`` against ``jax.vmap(res.scan_chunks)``,
``merge_state``, the multi-stream executor, a DP session engine, interop),
and a Hypothesis state machine of the port against a copy of
``tests/test_storm.py``'s numpy ``OracleModel``, local and durable.  Small
sizes as ``tests/test_storm.py``: 32 bins over a domain of 2^12, M = 4,
X = 2, chunks of 64, 2 + 1 slots.
"""
from __future__ import annotations

import dataclasses
import sys
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:         # benchmarks/ is a repo-root package
    sys.path.insert(0, str(REPO))

from repro.apps import dp as jdp
from repro.apps import histo as jhisto
from repro.core import executor as jexecutor
from repro.serve import SessionEngine as JSessionEngine
from repro_torch import interop
from repro_torch.apps import dp, histo
from repro_torch.core import compilemon, executor
from repro_torch.obs.metrics import parse_prometheus
from repro_torch.serve import DurableSessionEngine, SessionEngine
from repro_torch.serve.errors import (ClosedSessionError, QueuedSessionError,
                                      UnknownSessionError)

BINS, DOMAIN, M, X, CHUNK = 32, 1 << 12, 4, 2, 64
PRIMARY, SECONDARY, AOT = 2, 1, 2
MS_FIELDS = ("flush_ms", "admit_ms", "compile_stall_ms")
MS_FAMILIES = ("flush_latency_ms", "admit_latency_ms")
BUILD_FAMILIES = ("retraces_total", "compile_stall_ms_total")


def _oracle(keys) -> np.ndarray:
    keys = np.concatenate(keys) if isinstance(keys, list) and keys else keys
    if isinstance(keys, list):
        keys = np.zeros(0, np.int64)
    return histo.oracle(np.asarray(keys), BINS, DOMAIN, M)


def _data(seed: int, n: int, alpha: Optional[float] = None) -> np.ndarray:
    """[n, 2] int32 tuples: uniform keys, or Zipf keys at ``alpha``."""
    if alpha is not None:
        from repro_torch.data.zipf import zipf_tuples
        return zipf_tuples(n, DOMAIN, alpha, seed=seed)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, DOMAIN, size=n, dtype=np.int64)
    return np.stack([keys, np.ones_like(keys)], axis=1).astype(np.int32)


def _engine(spec=None, **kw):
    kw.setdefault("primary_slots", PRIMARY)
    kw.setdefault("secondary_slots", SECONDARY)
    eng = SessionEngine(spec or histo.make_spec(BINS, DOMAIN, M), num_pri=M,
                        num_sec=X, chunk_size=CHUNK, device="cpu", **kw)
    eng._GAUGE_SCAN_S = 0.0
    return eng


def _series(eng, warm: bool) -> Dict[tuple, Optional[float]]:
    """{(name, labels): value} of the engine's Prometheus text; wall-clock
    values (and, unless ``warm``, build counters) read as None."""
    out = {}
    for name, labels, value in parse_prometheus(eng.obs.registry.prometheus_text()):
        timed = (name.startswith(MS_FAMILIES) and not name.endswith("_count")) \
            or (name.startswith(BUILD_FAMILIES) and not warm)
        out[(name, tuple(sorted(labels.items())))] = None if timed else value
    return out


def _rows(eng, warm: bool) -> List[dict]:
    skip = MS_FIELDS + (() if warm else ("n_retraces",))
    return [{k: v for k, v in r.items() if k not in skip} for r in eng._telemetry]


def _answer_eq(got, want):
    if isinstance(want, tuple) and not hasattr(want, "_fields"):   # close
        _answer_eq(got[0], want[0])
        assert got[1] == want[1]
    elif hasattr(want, "_fields"):                                 # DPBuffers
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    elif want is None or isinstance(want, (int, list)):
        assert got == want
    else:
        assert isinstance(got, np.ndarray)
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))


class Twin:
    """One op script, two engines (JAX's and the port's), checked after
    every op.  ``mesh`` goes to the port's engine only (a meshed port
    engine against JAX's local one): the two then differ in the mesh keys
    of their telemetry config alone."""

    def __init__(self, jspec=None, spec=None, mesh=None, **kw):
        kw.setdefault("primary_slots", PRIMARY)
        kw.setdefault("secondary_slots", SECONDARY)
        shape = dict(num_pri=M, num_sec=X, chunk_size=CHUNK)
        self.j = JSessionEngine(jspec or jhisto.make_spec(BINS, DOMAIN, M), **shape, **kw)
        self.p = SessionEngine(spec or histo.make_spec(BINS, DOMAIN, M), **shape,
                               device="cpu", mesh=mesh, **kw)
        self.j._GAUGE_SCAN_S = self.p._GAUGE_SCAN_S = 0.0
        self.warm_from: Optional[int] = None     # telemetry row where both are warm

    def __getattr__(self, op):
        def both(*args, **kw):
            out = []
            for eng in (self.j, self.p):
                try:
                    out.append((getattr(eng, op)(*args, **kw), None))
                except (ValueError, RuntimeError) as e:
                    out.append((None, e))
            (want, jerr), (got, perr) = out
            # the packages have one taxonomy each: same class name, message
            assert type(perr).__name__ == type(jerr).__name__, (op, jerr, perr)
            assert str(perr) == str(jerr)
            if jerr is None:
                _answer_eq(got, want)
            self.check()
            return got
        return both

    def check(self):
        j, p = self.j, self.p
        for attr in ("_next_sid", "_flush_no", "_slot_reschedules", "_slot_sid",
                     "_storms", "_n_admitted_batch", "_feat_shape"):
            assert getattr(p, attr) == getattr(j, attr), attr
        assert list(p._queue) == list(j._queue)
        assert sorted(p._free_slots) == sorted(j._free_slots)
        np.testing.assert_array_equal(p._sec_assign, j._sec_assign)
        assert set(p.sessions) == set(j.sessions)
        for sid, js in j.sessions.items():
            ps = p.sessions[sid]
            assert (ps.tenant, ps.slot, ps.closed, ps.backlog_tuples, ps.backlog_off) == \
                (js.tenant, js.slot, js.closed, js.backlog_tuples, js.backlog_off)
            assert ps.stats.as_dict() == js.stats.as_dict(), sid
        if self.warm_from is None and j._aot and p._aot:
            self.warm_from = len(j._telemetry)
        warm = self.warm_from is not None
        assert _rows(p, False) == _rows(j, False)
        if warm:
            assert all(r["n_retraces"] == 0 for r in list(j._telemetry)[self.warm_from:])
            assert all(r["n_retraces"] == 0 for r in list(p._telemetry)[self.warm_from:])
        assert _series(p, False) == _series(j, False)
        tj = j.telemetry_record(validate=False)["extra"]
        tp = p.telemetry_record(validate=True)["extra"]
        if p.mesh is not None:
            tj = {**tj, "config": {**tj["config"], "mesh_devices": p.mesh.size,
                                   "lanes_per_device": p.num_lanes // p.mesh.size}}
        assert tp["config"] == tj["config"]
        ints = ("sessions_opened", "flushes", "slot_reschedules", "tuples_flushed",
                "storms", "batch_admitted")
        assert {k: tp["totals"][k] for k in ints} == {k: tj["totals"][k] for k in ints}
        assert tp["telemetry"] == tj["telemetry"]


# ------------------------------------------------------------ SessionEngine

@pytest.mark.parametrize("alpha", [0.0, 1.5])
@pytest.mark.parametrize("ragged", [False, True])
def test_bit_exact_vs_one_shot(alpha, ragged):
    """Ragged appends with random engine flushes: the port's close equals
    the port's one-shot executor, the oracle and the JAX engine."""
    n = 6 * CHUNK + (37 if ragged else 0)
    data = _data(1, n, alpha)
    tw = Twin()
    sid = tw.open()
    rng = np.random.default_rng(0)
    i = 0
    while i < n:
        step = int(rng.integers(1, CHUNK + 50))
        tw.append(sid, data[i:i + step])
        i += step
        if rng.random() < 0.5:
            tw.flush()
    merged, _ = tw.close(sid)
    from repro_torch.data.pipeline import chunk_stream
    ts = chunk_stream(data, CHUNK, pad_tail=True)
    solo, _ = executor.make_executor(histo.make_spec(BINS, DOMAIN, M), M, X, CHUNK,
                                     device="cpu")(ts.body, mask=ts.mask)
    np.testing.assert_array_equal(merged, solo.numpy())
    np.testing.assert_array_equal(merged, _oracle(data[:, 0]))


def test_ragged_append_equivalence():
    data = _data(2, 3 * CHUNK + 41, 1.5)
    results = []
    for cuts in ([len(data)], [100, 1, 33, len(data) - 134], [CHUNK] * 3 + [41]):
        tw = Twin()
        sid = tw.open()
        i = 0
        for c in cuts:
            tw.append(sid, data[i:i + c])
            i += c
        np.testing.assert_array_equal(tw.query(sid), _oracle(data[:, 0]))
        results.append(tw.close(sid)[0])
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])


def test_query_is_non_destructive():
    a, b = _data(3, 2 * CHUNK + 7, 1.5), _data(4, CHUNK + 19)
    tw = Twin()
    sid = tw.open()
    tw.append(sid, a)
    np.testing.assert_array_equal(tw.query(sid), _oracle(a[:, 0]))
    np.testing.assert_array_equal(tw.query(sid), _oracle(a[:, 0]))
    tw.append(sid, b)
    merged, stats = tw.close(sid)
    np.testing.assert_array_equal(merged, _oracle([a[:, 0], b[:, 0]]))
    assert stats["queries"] == 2


def test_tenant_isolation_and_slot_recycling():
    data = {t: _data(10 + t, 2 * CHUNK + 13 * t, 0.7 * t) for t in range(4)}
    tw = Twin()
    sids = {t: tw.open(f"t{t}") for t in range(4)}
    assert sum(tw.p.sessions[s].slot is not None for s in sids.values()) == PRIMARY
    for t in range(4):
        tw.append(sids[t], data[t])
    for t in range(4):
        merged, _ = tw.close(sids[t])
        np.testing.assert_array_equal(merged, _oracle(data[t][:, 0]))


def test_queued_session_never_answers_empty():
    tw = Twin(primary_slots=1, secondary_slots=0)
    a, b = tw.open(), tw.open()
    data = _data(5, 300)
    tw.append(b, data)
    with pytest.raises(QueuedSessionError, match="queued"):
        tw.p.query(b)
    tw.query(b)                       # both raise, with the same message
    tw.close(b)                       # both refuse to discard
    tw.close(a)
    np.testing.assert_array_equal(tw.close(b)[0], _oracle(data[:, 0]))
    tw2 = Twin(primary_slots=1, secondary_slots=0)
    tw2.open()
    merged, stats = tw2.close(tw2.open())    # an empty queued session closes
    assert merged.sum() == 0 and stats["tuples_appended"] == 0


def test_error_messages_equal_jax():
    tw = Twin()
    sid = tw.open()
    tw.append(sid, _data(6, 64))
    tw.query(sid + 999)
    tw.close(sid + 999)
    tw.append(sid + 999, _data(0, 4))
    tw.append(sid, np.zeros((4, 3), np.int32))       # shape mismatch
    tw.query(sid, scope="bogus")
    tw.close(sid)
    tw.append(sid, _data(7, 64))                     # closed sid
    tw.open_batch(["a", "b"], first=[None])          # first-append count
    with pytest.raises(ClosedSessionError, match="closed sid cannot be reused"):
        tw.p.append(sid, _data(7, 4))
    with pytest.raises(UnknownSessionError, match=r"issued 1 sid\(s\), 0 open"):
        tw.p.query(sid + 7)


def test_mesh_and_device_refusals():
    from repro_torch.core.distributed import make_mesh
    spec = histo.make_spec(BINS, DOMAIN, M)
    with pytest.raises(ValueError, match="mesh has no 'lanes' axis"):
        SessionEngine(spec, num_pri=M, num_sec=X, chunk_size=CHUNK,
                      mesh=make_mesh(1, "pe", device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="must be divisible"):
        SessionEngine(spec, num_pri=M, num_sec=X, chunk_size=CHUNK, primary_slots=2,
                      secondary_slots=1, mesh=make_mesh(2, "lanes", device="cpu"),
                      device="cpu")
    with pytest.raises(ValueError, match="secondary_slots=0"):
        _engine(dp.make_spec(3, M, 256), secondary_slots=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SessionEngine(spec, num_pri=M, num_sec=X, chunk_size=CHUNK)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2, "lanes")


def test_tuned_plan_config():
    from repro_torch.tune import SearchSpace, autotune
    spec = histo.make_spec(BINS, DOMAIN, M)
    sample = _data(8, 4096, 1.5)
    tuned = autotune(spec, sample, space=SearchSpace(m_candidates=(M,),
                                                     chunk_sizes=(CHUNK,)),
                     tolerance=0.1, device="cpu")
    eng = SessionEngine(spec, tuned=tuned, primary_slots=2, secondary_slots=1,
                        device="cpu")
    assert (eng.num_pri, eng.num_sec, eng.chunk_size) == (M, tuned.num_sec, CHUNK)
    sid = eng.open()
    eng.append(sid, sample)
    np.testing.assert_array_equal(eng.close(sid)[0], _oracle(sample[:, 0]))
    with pytest.raises(ValueError, match="conflicts"):
        SessionEngine(spec, tuned=tuned, num_pri=M + 1, device="cpu")


def test_telemetry_record_schema():
    from benchmarks.common import validate_record
    tw = Twin()
    sid = tw.open()
    tw.append(sid, _data(9, 3 * CHUNK, 1.5))
    tw.flush()
    tw.close(sid)
    rec = validate_record(tw.p.telemetry_record())
    assert rec["rows"] and rec["rows"][0]["tuples"] == 3 * CHUNK
    assert rec["extra"]["totals"]["sessions_opened"] == 1


# --------------------------------------------------------- per-session flush

def test_query_scopes_identical_results():
    data = {t: _data(20 + t, 2 * CHUNK + 31 * t, 0.7 * t) for t in range(2)}
    snaps = {}
    for scope in ("session", "engine"):
        tw = Twin()
        sids = {t: tw.open() for t in data}
        for t, d in data.items():
            tw.append(sids[t], d)
        snaps[scope] = {t: tw.query(sids[t], scope=scope) for t in data}
    for t, d in data.items():
        np.testing.assert_array_equal(snaps["session"][t], snaps["engine"][t])
        np.testing.assert_array_equal(snaps["session"][t], _oracle(d[:, 0]))


def test_session_flush_leaves_other_backlogs_and_uses_granted_lanes():
    tw = Twin(primary_slots=2, secondary_slots=2)
    hot, cold = tw.open(), tw.open()
    d_hot, d_cold = _data(30, 6 * CHUNK + 13, 1.5), _data(31, 3 * CHUNK + 17)
    tw.append(hot, d_hot)
    tw.append(cold, d_cold)
    tw.flush_session(cold)
    assert tw.p.sessions[hot].backlog_tuples == len(d_hot)
    tw.flush()                        # grants secondaries to the hot session
    assert tw.p._lane_group(tw.p.sessions[hot].slot) != [tw.p.sessions[hot].slot]
    more = _data(32, 4 * CHUNK + 7, 1.5)
    tw.append(hot, more)
    np.testing.assert_array_equal(tw.query(hot), _oracle([d_hot[:, 0], more[:, 0]]))
    assert tw.p.sessions[hot].stats.sec_lane_flushes > 0
    tw.flush_session(cold + 5)        # unknown
    tw.close(hot)
    tw.close(cold)
    rows = tw.p.telemetry_record()["rows"]
    assert [r["scope"] for r in rows][:2] == ["session", "engine"]


def test_queued_session_flush_raises():
    tw = Twin(primary_slots=1)
    tw.open()
    queued = tw.open()
    tw.flush_session(queued)
    with pytest.raises(QueuedSessionError, match="queued"):
        tw.p.flush_session(queued)


# ------------------------------------------------------ tenant skew scheduling

@pytest.mark.parametrize("backlog,primary,secondary,min_grant", [
    ([40.0, 2.0, 2.0], 3, 2, 2), ([10.0] * 4, 4, 3, 2), ([1.0, 0.0], 2, 2, 2),
    ([7.0, 7.0, 3.0, 0.0, 12.0, 5.0], 6, 4, 2), ([0.0, 0.0, 0.0], 3, 3, 1)])
def test_plan_secondary_equals_jax(backlog, primary, secondary, min_grant):
    kw = dict(primary_slots=primary, secondary_slots=secondary,
              min_grant_chunks=min_grant)
    tw = Twin(**kw)
    b = np.asarray(backlog, np.float32)
    np.testing.assert_array_equal(tw.p.plan_secondary(b), tw.j.plan_secondary(b))
    rng = np.random.default_rng(3)
    for _ in range(10):
        b = rng.integers(0, 50, size=primary).astype(np.float32)
        got = tw.p.plan_secondary(b)
        np.testing.assert_array_equal(got, tw.j.plan_secondary(b))
        granted = got[got >= 0]
        assert all(b[g] >= min_grant for g in granted)


def test_regrants_keep_exactness():
    tw = Twin(primary_slots=2, secondary_slots=2)
    sids = {t: tw.open() for t in range(2)}
    keys = {t: [] for t in range(2)}
    rng = np.random.default_rng(9)
    for r in range(6):                     # alternate who is hot
        for t in range(2):
            n = (6 if t == r % 2 else 1) * CHUNK + int(rng.integers(0, 50))
            batch = _data(10 * r + t, n, 1.5)
            keys[t].append(batch[:, 0])
            tw.append(sids[t], batch)
        tw.flush()
    assert tw.p._slot_reschedules > 0
    for t in range(2):
        merged, stats = tw.close(sids[t])
        np.testing.assert_array_equal(merged, _oracle(keys[t]))


# --------------------------------------------------------------- shape buckets

def _scenario(tw, seed=0, tenants=3):
    """Ragged multi-tenant appends with flushes, queries in both scopes and
    closes (backlogs up to 5 chunks: width chopping at W = 2)."""
    rng = np.random.default_rng(seed)
    sids = {t: tw.open(f"t{t}") for t in range(tenants)}
    keys = {t: [] for t in sids}
    for r in range(3):
        for t in sids:
            d = _data(100 * seed + 10 * r + t, int(rng.integers(0, 5 * CHUNK)),
                      (0.0, 1.5)[t % 2])
            keys[t].append(d[:, 0])
            tw.append(sids[t], d)
        if r % 2 == 0:
            tw.flush()
        t = r % tenants
        if tw.p.sessions[sids[t]].slot is not None:
            np.testing.assert_array_equal(tw.query(sids[t], scope=("session", "engine")[r % 2]),
                                          _oracle(keys[t]))
    for t in sids:
        np.testing.assert_array_equal(tw.close(sids[t])[0], _oracle(keys[t]))


def test_buckets_bit_exact_and_zero_builds_after_warmup():
    """The bucketed engine answers like JAX's bucketed engine, and once
    warm neither records a build event (JAX: XLA compiles; port: nvcc
    builds and library loads) on any flush path."""
    tw = Twin(primary_slots=3, aot_buckets=AOT)
    sid = tw.open()
    tw.append(sid, _data(40, 8))            # triggers warmup on both
    tw.close(sid)
    aot = tw.p.telemetry_record()["extra"]["aot"]
    assert aot["widths"] == [1, 2] and aot["n_executables"] == len(tw.p._aot)
    assert {k: aot[k] for k in ("widths", "group_buckets", "admit_buckets",
                                "n_executables")} == \
        {k: tw.j._aot_info[k] for k in ("widths", "group_buckets", "admit_buckets",
                                        "n_executables")}
    assert set(tw.p._aot) == set(tw.j._aot)
    before = compilemon.snapshot()
    _scenario(tw, seed=1)
    assert compilemon.since(before).n_compiles == 0
    assert tw.p.telemetry_record()["extra"]["totals"]["n_retraces"] == 0
    plain = Twin(primary_slots=3)
    _scenario(plain, seed=1)


def test_group_padding_leaves_other_sessions_untouched():
    tw = Twin(primary_slots=2, secondary_slots=3, aot_buckets=AOT)
    sids = [tw.open(), tw.open()]
    d0, d1 = _data(50, 10 * CHUNK + 13, 1.5), _data(51, 6 * CHUNK + 7, 1.5)
    tw.append(sids[0], d0)
    tw.append(sids[1], d1)
    tw.flush()
    assert len(tw.p._lane_group(tw.p.sessions[sids[0]].slot)) == 3   # bucket 4
    tail = _data(52, 2 * CHUNK + 9, 1.5)
    tw.append(sids[0], tail)
    tw.flush_session(sids[0])               # pads with a lane outside the group
    np.testing.assert_array_equal(tw.query(sids[0]), _oracle([d0[:, 0], tail[:, 0]]))
    np.testing.assert_array_equal(tw.query(sids[1]), _oracle(d1[:, 0]))


def test_warmup_validation_and_knobs():
    with pytest.raises(ValueError, match="aot_buckets"):
        _engine(aot_buckets=0)
    with pytest.raises(RuntimeError, match="aot_buckets"):
        _engine().warmup()
    eng = _engine(aot_buckets=3)
    assert eng._aot_widths == (1, 2, 4)
    with pytest.raises(RuntimeError, match="tuple shape"):
        eng.warmup()
    info = eng.warmup(dtype=np.int32, feat_shape=(2,))
    assert info["n_executables"] == len(eng._aot) > 0
    with pytest.raises(ValueError, match="dtype"):
        eng.warmup(dtype=np.float32)


@pytest.mark.parametrize("primary,secondary,aot", [(2, 2, 2), (3, 1, 4), (5, 0, 1),
                                                   (1, 3, 8)])
def test_bucket_table_equals_jax(primary, secondary, aot):
    kw = dict(primary_slots=primary, secondary_slots=secondary, aot_buckets=aot)
    p = _engine(**kw)
    p.warmup(dtype=np.int64, feat_shape=(2,))
    j = JSessionEngine(jhisto.make_spec(BINS, DOMAIN, M), num_pri=M, num_sec=X,
                       chunk_size=CHUNK, **kw)
    assert (p._aot_widths, p._group_buckets, p._admit_buckets) == \
        (j._aot_widths, j._group_buckets, j._admit_buckets)
    legal = {("eng", w) for w in p._aot_widths}
    for g in range(1, 2 + secondary):
        legal |= {("grp", p._group_bucket(g), w) for w in p._aot_widths}
    for k in range(1, 1 + primary):
        legal |= {("grp", p._admit_bucket(k), w) for w in p._aot_widths}
    assert set(p._aot) == legal
    for wmax in range(1, 6 * p._aot_widths[-1] + 1):
        segs = list(p._segments([list(range(wmax))]))
        assert segs == list(j._segments([list(range(wmax))]))
        assert all(("eng", w) in p._aot for _, w in segs)


def test_backlog_consumes_without_recopy():
    tw = Twin()
    sid = tw.open()
    keys = (np.arange(CHUNK + 30, dtype=np.int32) * 7) % DOMAIN
    tw.append(sid, np.stack([keys, np.ones_like(keys)], axis=1))
    tw.flush()                   # one full chunk runs, 30 tuples stay
    s = tw.p.sessions[sid]
    assert s.backlog_tuples == 30 and len(s.backlog) == 1 and s.backlog_off == CHUNK
    np.testing.assert_array_equal(tw.query(sid), _oracle(keys))


# ----------------------------------------------------------- batched admission

def _storm(n, seed=0):
    sizes = [2 * CHUNK + 17, CHUNK, 73, 3 * CHUNK, CHUNK + 1]
    return [None if i == n - 1 else _data(seed + i, sizes[i % 5], (0.0, 1.5)[i % 2])
            for i in range(n)]


def test_open_batch_bit_exact_vs_serial_admission():
    kw = dict(primary_slots=3, secondary_slots=1, aot_buckets=AOT)
    firsts = _storm(7, seed=50)
    tenants = [f"t{i}" for i in range(7)]
    tails = [_data(100 + i, CHUNK + 31 * i, 1.0) for i in range(7)]
    batch = Twin(**kw)
    sids = batch.open_batch(tenants, first=firsts)
    serial = _engine(**kw)
    for t, f in zip(tenants, firsts):
        sid = serial.open(t)
        if f is not None:
            serial.append(sid, f)
    assert (batch.p._slot_sid, list(batch.p._queue)) == \
        (serial._slot_sid, list(serial._queue))
    for sid, tail in zip(sids, tails):
        batch.append(sid, tail)
        serial.append(sid, tail)
    for sid, first, tail in zip(sids, firsts, tails):
        got = batch.close(sid)[0]
        np.testing.assert_array_equal(got, serial.close(sid)[0])
        np.testing.assert_array_equal(
            got, _oracle([tail[:, 0]] if first is None else [first[:, 0], tail[:, 0]]))


def test_fifo_overflow_and_drain_deterministic():
    tw = Twin(primary_slots=2, secondary_slots=0)
    sids = tw.open_batch([f"t{i}" for i in range(5)])
    assert sids == [0, 1, 2, 3, 4] and tw.p._slot_sid == [0, 1]
    for sid in (1, 0, 2, 3):
        tw.close(sid)
    late = tw.open("late")
    assert tw.p._slot_sid == [late, 4] and not tw.p._queue
    tw2 = Twin(primary_slots=1, secondary_slots=0)
    a = tw2.open("a")
    mid = tw2.open_batch(["b", "c"])
    d = tw2.open("d")
    order = []
    for _ in range(4):
        order.append(tw2.p._slot_sid[0])
        tw2.close(order[-1])
    assert order == [a, *mid, d]


def test_storm_telemetry_and_zero_builds():
    tw = Twin(primary_slots=4, secondary_slots=1, aot_buckets=AOT)
    tw.p.warmup(dtype=np.int32, feat_shape=(2,))
    tw.j.warmup(dtype=np.int32, feat_shape=(2,))
    tw.check()
    sids = tw.open_batch([f"t{i}" for i in range(6)], first=_storm(6, seed=60))
    row = tw.p._telemetry[-1]
    assert (row["scope"], row["n_admitted"], row["n_queued_batch"]) == ("admit", 4, 2)
    assert 1 <= row["n_scan_dispatches"] <= 2 and row["n_retraces"] == 0
    for sid in sids:
        tw.close(sid)
    tw.open_batch(["x", "y", "z"], first=_storm(3, seed=70))
    tw.open_batch([])
    totals = tw.p.telemetry_record()["extra"]["totals"]
    assert totals["storms"] == 3 and totals["n_retraces_admit"] == 0


# ------------------------------------------------------- differential random walk

def _walk(tw, seed: int, n_ops: int):
    rng = np.random.default_rng(seed)
    ops = ["open", "open_batch", "append", "append", "query", "query_engine",
           "close", "flush", "flush_session", "bad"]
    for _ in range(n_ops):
        op = ops[rng.integers(len(ops))]
        sids = sorted(tw.p.sessions)
        pick = int(sids[rng.integers(len(sids))]) if sids else 0
        if op == "open":
            tw.open(f"t{rng.integers(3)}")
        elif op == "open_batch":
            k = int(rng.integers(1, 4))
            tw.open_batch([f"s{rng.integers(3)}" for _ in range(k)],
                          first=[None if rng.integers(4) == 0 else
                                 _data(int(rng.integers(1 << 30)),
                                       int(rng.integers(0, 3 * CHUNK)))
                                 for _ in range(k)])
        elif op == "append":
            tw.append(pick, _data(int(rng.integers(1 << 30)),
                                  int(rng.integers(0, 3 * CHUNK))))
        elif op == "query":
            tw.query(pick)
        elif op == "query_engine":
            tw.query(pick, scope="engine")
        elif op == "close":
            tw.close(pick)
        elif op == "flush":
            tw.flush()
        elif op == "flush_session":
            tw.flush_session(pick)
        else:
            tw.append(10_000 + pick, _data(0, 4))


@pytest.mark.parametrize("aot", [None, AOT])
def test_random_walk_equals_jax(aot):
    """60 random ops: answers, errors, slot tables, queues, session stats,
    integer telemetry fields and Prometheus series equal JAX's after every
    op (with the bucket table: zero build events once warm, both)."""
    _walk(Twin(aot_buckets=aot), seed=20261017, n_ops=60)


# ------------------------------------------------------------- DP under lanes

DP_BITS, DP_CAP = 4, 512


def _dp_lanes(lanes=3, chunks=5):
    from repro_torch.data.zipf import zipf_tuples
    t = np.stack([zipf_tuples(chunks * CHUNK, 1 << 16, 1.5 * l, seed=l)
                  for l in range(lanes)]).reshape(lanes, chunks, CHUNK, 2)
    mask = np.ones((lanes, chunks, CHUNK), bool)
    mask[0, -1, 40:] = False
    mask[-1] = False                      # an all-masked pad lane
    t[-1] = 0
    return t, mask


def _dp_state_eq(got, want):
    g = interop.state_to_numpy(got)
    for f in want.buffers._fields:
        np.testing.assert_array_equal(g["buffers"][f], np.asarray(getattr(want.buffers, f)),
                                      err_msg=f)
    for f in ("rr_base", "mode", "profile_hist", "chunks_in_mode", "reschedules"):
        np.testing.assert_array_equal(g[f], np.asarray(getattr(want, f)), err_msg=f)
    for f in ("assignment", "table", "counter"):
        np.testing.assert_array_equal(g["plan"][f], np.asarray(getattr(want.plan, f)))


def test_dp_scan_lanes_equals_jax_vmap():
    """DP under lanes: each lane appends to its own regions ([L, num_pe, T]
    one-hot), slot for slot equal to jax.vmap(res.scan_chunks), and so are
    the stats, merge_state and the multi-stream executor's output."""
    tuples, mask = _dp_lanes()
    res = executor.make_resumable_executor(dp.make_spec(DP_BITS, M, DP_CAP), M, X, CHUNK,
                                           device="cpu")
    jres = jexecutor.make_resumable_executor(jdp.make_spec(DP_BITS, M, DP_CAP), M, X, CHUNK)
    start = executor.stack_states(res.init_state(), 3)
    end, stats = res.scan_lanes(start, tuples, mask)
    jend, jstats = jres.scan_lanes(jexecutor.stack_states(jres.init_state(), 3),
                                   jnp.asarray(tuples), jnp.asarray(mask))
    _dp_state_eq(end, jend)
    for f in ("max_load", "modeled_cycles", "mode", "rescheduled", "workload"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), np.asarray(getattr(jstats, f)))
    merged = res.merge_state(end)
    assert merged.out.shape == (3, M + X, DP_CAP, 2)
    for f in ("out", "cursor", "dst_part"):
        np.testing.assert_array_equal(getattr(merged, f).numpy(),
                                      np.asarray(getattr(jres.merge_state(jend), f)))
    # each lane equals its stream alone, and the partitions equal the oracle
    for l in range(2):
        solo, _ = executor.make_executor(dp.make_spec(DP_BITS, M, DP_CAP), M, X, CHUNK,
                                         device="cpu")(tuples[l], mask=mask[l])
        lane = executor.take_lanes(end, l).buffers
        for f in ("out", "cursor", "dst_part"):
            assert torch.equal(getattr(lane, f), getattr(solo, f))
        parts = dp.partitions_from_buffers(lane, 1 << DP_BITS)
        live = tuples[l][mask[l]]
        for got, want in zip(parts, dp.oracle(live, DP_BITS)):
            assert dp.multiset_equal(got, want)
    assert not merged.cursor[-1].any()        # the pad lane appended nothing
    run = executor.make_multistream_executor(dp.make_spec(DP_BITS, M, DP_CAP), M, X, CHUNK,
                                             device="cpu")
    mout, _ = run(tuples, mask=mask)
    assert torch.equal(mout.out, merged.out) and torch.equal(mout.cursor, merged.cursor)


def test_dp_lane_state_moves_between_packages():
    """A JAX lanes-stacked DP state after 2 chunks, moved into the port
    through interop (lanes-stacked DPBuffers), continues as JAX's does; and
    state_to_numpy gives back the lanes-stacked fields."""
    import jax
    tuples, mask = _dp_lanes()
    res = executor.make_resumable_executor(dp.make_spec(DP_BITS, M, DP_CAP), M, X, CHUNK,
                                           device="cpu")
    jres = jexecutor.make_resumable_executor(jdp.make_spec(DP_BITS, M, DP_CAP), M, X, CHUNK)
    jmid, _ = jres.scan_lanes(jexecutor.stack_states(jres.init_state(), 3),
                              jnp.asarray(tuples[:, :2]), jnp.asarray(mask[:, :2]))
    jend, _ = jres.scan_lanes(jmid, jnp.asarray(tuples[:, 2:]), jnp.asarray(mask[:, 2:]))
    arrays = jax.tree.map(np.asarray, dataclasses.asdict(jmid))
    arrays["buffers"] = arrays["buffers"]._asdict()
    mid = interop.state_from_numpy(arrays, device="cpu")
    assert mid.buffers.out.shape == (3, M + X, DP_CAP, 2)
    end, _ = res.scan_lanes(mid, tuples[:, 2:], mask[:, 2:])
    _dp_state_eq(end, jend)
    back = interop.state_to_numpy(end)["buffers"]
    assert back["cursor"].shape == (3, M + X)


def test_dp_session_engine_equals_jax():
    """A DP SessionEngine (secondary_slots=0): ragged appends, queries and
    closes equal JAX's DP engine region for region, and the partitions of
    each tenant equal the oracle as multisets."""
    spec, jspec = dp.make_spec(DP_BITS, M, DP_CAP), jdp.make_spec(DP_BITS, M, DP_CAP)
    tw = Twin(jspec=jspec, spec=spec, primary_slots=2, secondary_slots=0)
    sids = [tw.open("a"), tw.open("b"), tw.open("c")]
    kept = {s: [] for s in sids}
    for r in range(3):
        for i, sid in enumerate(sids):
            d = _data(200 + 10 * r + i, int(50 + 97 * (r + i)), 1.5)
            kept[sid].append(d)
            tw.append(sid, d)
        tw.flush()
    got = tw.query(sids[0])
    parts = dp.partitions_from_buffers(got, 1 << DP_BITS)
    for p, want in zip(parts, dp.oracle(np.concatenate(kept[sids[0]]), DP_BITS)):
        assert dp.multiset_equal(p, want)
    for sid in sids:
        tw.close(sid)


# ----------------------------------------- stateful machine against the oracle

class OracleModel:
    """A copy of ``tests/test_storm.py``'s host-side model of the engine's
    documented semantics: exact session bookkeeping (slots, queue, pending
    counts); answers are the numpy oracle over every key appended so far."""

    def __init__(self, primary_slots: int, chunk: int):
        self.primary = primary_slots
        self.chunk = chunk
        self.sessions: Dict[int, Dict[str, Any]] = {}
        self.slot_sid: List[Optional[int]] = [None] * primary_slots
        self.queue: List[int] = []
        self.free: List[int] = list(range(primary_slots))   # kept sorted
        self.next_sid = 0

    def _admit(self) -> None:
        while self.queue and self.free:
            sid = self.queue.pop(0)
            slot = self.free.pop(0)            # lowest free slot, FIFO sid
            self.slot_sid[slot] = sid
            self.sessions[sid]["slot"] = slot

    def _get(self, sid: int, allow_closed: bool = False) -> Dict[str, Any]:
        s = self.sessions.get(sid)
        if s is None:
            raise UnknownSessionError(f"unknown session id {sid}")
        if s["closed"] and not allow_closed:
            raise ClosedSessionError(f"session {sid} is closed")
        return s

    def open(self, tenant: str) -> int:
        sid = self.next_sid
        self.next_sid += 1
        self.sessions[sid] = {"tenant": tenant, "keys": [], "pending": 0,
                              "slot": None, "closed": False}
        self.queue.append(sid)
        self._admit()
        return sid

    def append(self, sid: int, data: np.ndarray) -> None:
        s = self._get(sid)
        if len(data):
            s["keys"].append(np.asarray(data)[:, 0].copy())
            s["pending"] += len(data)

    def open_batch(self, tenants, first) -> List[int]:
        sids = []
        for i, t in enumerate(tenants):
            sid = self.open(t)
            sids.append(sid)
            if first is not None and first[i] is not None:
                self.append(sid, first[i])
        for sid in sids:                       # the storm flush: full chunks
            s = self.sessions[sid]             # of admitted storm sessions
            if s["slot"] is not None:          # run immediately
                s["pending"] %= self.chunk
        return sids

    def flush(self, force=()) -> None:
        force = set(force)
        self._admit()
        for sid in self.slot_sid:
            if sid is None:
                continue
            s = self.sessions[sid]
            s["pending"] = 0 if sid in force else s["pending"] % self.chunk

    def flush_session(self, sid: int) -> None:
        s = self._get(sid)
        if s["slot"] is None:
            raise QueuedSessionError(f"session {sid} is queued")
        s["pending"] = 0

    def query(self, sid: int, scope: str = "session") -> np.ndarray:
        s = self._get(sid)
        if s["slot"] is None:
            raise QueuedSessionError(f"session {sid} is queued")
        if scope == "engine":
            self.flush(force=(sid,))
        else:
            s["pending"] = 0
        return _oracle(s["keys"])

    def close(self, sid: int) -> np.ndarray:
        s = self._get(sid)
        if s["slot"] is None and s["pending"]:
            raise QueuedSessionError(f"session {sid} is queued with data")
        out = _oracle(s["keys"])
        s["pending"] = 0
        if s["slot"] is not None:
            self.slot_sid[s["slot"]] = None
            self.free = sorted(self.free + [s["slot"]])
            s["slot"] = None
        else:
            self.queue.remove(sid)
        s["closed"] = True
        self._admit()
        return out


class OracleHarness:
    """The port's engine (local or durable) against ``OracleModel``: the
    same exception class, oracle-exact answers, and after every op the slot
    table, FIFO queue, free slots and per-session backlog of the model; no
    build event once the bucket table is warm.

    With ``network=True`` the session ops (``ep()``) travel through a live
    ``SessionService`` (``admission="fifo"``, the model's FIFO slots) over
    two client connections that alternate request by request; the wire
    clients re-raise the engine's exception classes.  ``net_drop`` ships
    half an append frame on a fresh connection and hangs up, which must not
    touch the engine; ``recover`` stops the service with the engine and puts
    a new service in front of the recovered one.  ``flush`` and
    ``flush_session`` stay engine calls: a blocking client returns only
    after the service's worker has finished the batch."""

    def __init__(self, workdir=None, network: bool = False, mesh=None):
        kw = dict(num_pri=M, num_sec=X, chunk_size=CHUNK, primary_slots=PRIMARY,
                  secondary_slots=SECONDARY, aot_buckets=AOT, device="cpu", mesh=mesh)
        self.mesh = mesh
        self.spec = histo.make_spec(BINS, DOMAIN, M)
        self.workdir = workdir
        self.eng = (DurableSessionEngine(self.spec, directory=workdir, checkpoint_every=2,
                                         keep=2, **kw)
                    if workdir else SessionEngine(self.spec, **kw))
        self.model = OracleModel(PRIMARY, CHUNK)
        self.n_recovers = 0
        self.network = network
        self.svc, self.clients, self.n_ops = None, [], 0
        if network:
            self._start_service()

    def _start_service(self):
        from repro_torch.serve.service import ServiceClient, ServiceConfig, SessionService
        self.svc = SessionService(self.eng, ServiceConfig(admission="fifo"))
        self.svc.start()
        self.clients = [ServiceClient(*self.svc.address, timeout=60) for _ in range(2)]

    def _stop_service(self):
        for c in self.clients:
            c.close_conn()
        self.clients = []
        if self.svc is not None:
            self.svc.stop()
            self.svc = None

    def ep(self):
        """The endpoint of a session op: the engine, or one of the two wire
        clients in turn."""
        if not self.network:
            return self.eng
        self.n_ops += 1
        return self.clients[self.n_ops % 2]

    def net_drop(self, sid: int, data: np.ndarray):
        from repro_torch.serve.service import ServiceClient, encode_frame
        a = np.ascontiguousarray(data)
        frame = encode_frame({"op": "append", "sid": int(sid), "id": 1,
                              "array": {"dtype": a.dtype.str, "shape": list(a.shape)}},
                             a.tobytes())
        raw = ServiceClient(*self.svc.address, timeout=60)
        raw.send_raw(frame[:max(9, len(frame) // 2)])
        raw.close_conn()
        self.check()

    def both(self, eng_fn, model_fn):
        try:
            got, got_exc = eng_fn(), None
        except (ValueError, RuntimeError) as e:
            got, got_exc = None, type(e)
        try:
            want, want_exc = model_fn(), None
        except (ValueError, RuntimeError) as e:
            want, want_exc = None, type(e)
        assert got_exc is want_exc, (got_exc, want_exc)
        self.check()
        if want is not None and isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got[0] if isinstance(got, tuple) else got, want)
        return got, want

    def recover(self):
        self._stop_service()
        self.eng.shutdown()
        self.eng = SessionEngine.recover(self.spec, self.workdir, mesh=self.mesh,
                                         device="cpu")
        if self.network:
            self._start_service()
        assert self.eng.recovery_info["replay_anomalies"] == 0
        self.n_recovers += 1
        self.check()

    def shutdown(self):
        self._stop_service()
        if isinstance(self.eng, DurableSessionEngine):
            self.eng.shutdown()

    def check(self):
        eng, m = self.eng, self.model
        assert eng._next_sid == m.next_sid
        assert list(eng._slot_sid) == list(m.slot_sid)
        assert list(eng._queue) == list(m.queue)
        assert sorted(eng._free_slots) == m.free
        assert set(eng.sessions) == set(m.sessions)
        for sid, ms in m.sessions.items():
            es = eng.sessions[sid]
            assert es.closed == ms["closed"]
            assert es.backlog_tuples == ms["pending"], (
                f"sid {sid}: backlog {es.backlog_tuples} != model pending {ms['pending']}")
            assert es.backlog_tuples == sum(len(a) for a in es.pending_arrays())
        assert all(r["n_retraces"] == 0 for r in eng._telemetry)


try:
    from hypothesis import HealthCheck, settings
    from hypothesis import strategies as st
    from hypothesis.stateful import (RuleBasedStateMachine, precondition, rule,
                                     run_state_machine_as_test)
    HAVE_HYPOTHESIS = True
except ImportError:                       # pragma: no cover
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    class _PortStorm(RuleBasedStateMachine):
        durable = False
        network = False
        mesh = None          # a core.distributed.Mesh for the port's engine

        def __init__(self):
            super().__init__()
            self._tmp = tempfile.TemporaryDirectory() if self.durable else None
            self.h = OracleHarness(self._tmp.name if self._tmp else None,
                                   network=self.network, mesh=self.mesh)

        def teardown(self):
            self.h.shutdown()
            if self._tmp is not None:
                self._tmp.cleanup()

        def _sid(self, pick: int) -> int:
            sids = sorted(self.h.model.sessions)
            return sids[pick % len(sids)] if sids else 10_000 + pick

        @rule(t=st.integers(0, 2))
        def open(self, t):
            ep = self.h.ep()
            got, want = self.h.both(lambda: ep.open(f"t{t}"),
                                    lambda: self.h.model.open(f"t{t}"))
            assert got == want

        @rule(k=st.integers(1, 4), seed=st.integers(0, 2**31 - 1),
              sizes=st.lists(st.integers(0, 3 * CHUNK), min_size=1, max_size=4))
        def open_batch(self, k, seed, sizes):
            sizes = (sizes * k)[:k]
            first = [_data(seed + i, n) for i, n in enumerate(sizes)]
            tenants = [f"s{seed % 5}-{i}" for i in range(k)]
            ep = self.h.ep()
            got, want = self.h.both(lambda: ep.open_batch(tenants, first=first),
                                    lambda: self.h.model.open_batch(tenants, first))
            assert got == want

        @rule(pick=st.integers(0, 63), seed=st.integers(0, 2**31 - 1),
              n=st.integers(0, 3 * CHUNK))
        def append(self, pick, seed, n):
            sid, d, ep = self._sid(pick), _data(seed, n), self.h.ep()
            self.h.both(lambda: ep.append(sid, d), lambda: self.h.model.append(sid, d))

        @rule(pick=st.integers(0, 63), scope=st.sampled_from(["session", "engine"]))
        def query(self, pick, scope):
            sid, ep = self._sid(pick), self.h.ep()
            self.h.both(lambda: ep.query(sid, scope=scope),
                        lambda: self.h.model.query(sid, scope))

        @rule(pick=st.integers(0, 63))
        def close(self, pick):
            sid, ep = self._sid(pick), self.h.ep()
            self.h.both(lambda: ep.close(sid), lambda: self.h.model.close(sid))

        @rule()
        def flush(self):
            self.h.both(self.h.eng.flush, self.h.model.flush)

        @rule(pick=st.integers(0, 63))
        def flush_session(self, pick):
            sid = self._sid(pick)
            self.h.both(lambda: self.h.eng.flush_session(sid),
                        lambda: self.h.model.flush_session(sid))

        @precondition(lambda self: self.durable and self.h.n_recovers < 2)
        @rule()
        def recover(self):
            self.h.recover()

        @precondition(lambda self: self.network)
        @rule(pick=st.integers(0, 63), seed=st.integers(0, 2**31 - 1),
              n=st.integers(1, 2 * CHUNK))
        def net_drop(self, pick, seed, n):
            self.h.net_drop(self._sid(pick), _data(seed, n))

    class _PortStormDurable(_PortStorm):
        durable = True

    _MACHINE_SETTINGS = dict(stateful_step_count=15, deadline=None, database=None,
                             suppress_health_check=list(HealthCheck))

    def test_stateful_machine_local():
        run_state_machine_as_test(_PortStorm, settings=settings(
            max_examples=15, **_MACHINE_SETTINGS))

    def test_stateful_machine_durable():
        """Recovery at any point: the recovered engine's backlogs, slot
        table and queue equal the model's (the flush markers), answers
        oracle-exact."""
        run_state_machine_as_test(_PortStormDurable, settings=settings(
            max_examples=15, **_MACHINE_SETTINGS))
