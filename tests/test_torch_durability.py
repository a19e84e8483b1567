"""The port's durability subsystem (``repro_torch.serve.durability``) on the
CPU: the local cases of ``tests/test_durability.py`` (WAL framing and torn
tails, checkpoint + WAL-tail crash recovery, corrupt checkpoints, WAL GC,
queued sessions, the preemption drain, durable == plain, the bucket table
after recovery, a crash mid-storm), and the formats shared with the JAX
package: the same records through both ``WriteAheadLog``s give
byte-identical files, a directory written by JAX's durable engine recovers
in the port, and one the port wrote recovers in JAX, answers equal.

The in-process crash idiom of the JAX suite: abandon the engine without
``shutdown`` -- the WAL is flushed to the OS per record and checkpoints are
atomic, so the directory is what a SIGKILL at that point would leave.

The port logs where its flushes ran (``admit``, ``flush`` and ``fsess``
marker records, the one divergence from the JAX log), so a recovered
engine's backlogs, flush count, slot table and lane states equal those of
an engine that never crashed; the JAX engine restores them only at
checkpoint granularity.  ``test_storm_recovery_restores_backlogs`` holds
the falsifying example of ``tests/test_storm.py``'s durable machine
(``open_batch(k=1, sizes=[128, 0]); recover()``)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from repro.apps import histo as jhisto
from repro.serve import DurableSessionEngine as JDurableSessionEngine
from repro.serve import SessionEngine as JSessionEngine
from repro.serve import WriteAheadLog as JWriteAheadLog
from repro_torch.apps import histo
from repro_torch.core import compilemon
from repro_torch.serve import (DurableSessionEngine, EnginePreempted, SessionEngine,
                               WriteAheadLog, recover)
from repro_torch.train import PreemptionGuard

BINS, DOMAIN, M, X, CHUNK = 32, 1 << 12, 4, 2, 64


def _spec():
    return histo.make_spec(BINS, DOMAIN, M)


def _oracle(keys) -> np.ndarray:
    if isinstance(keys, list):
        keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    return histo.oracle(np.asarray(keys), BINS, DOMAIN, M)


def _data(seed: int, n: int, alpha: float = 1.5) -> np.ndarray:
    from repro_torch.data.zipf import zipf_tuples
    return zipf_tuples(n, DOMAIN, alpha, seed=seed)


def _engine(directory, **kw):
    kw.setdefault("primary_slots", 3)
    kw.setdefault("secondary_slots", 2)
    kw.setdefault("checkpoint_every", 2)
    return DurableSessionEngine(_spec(), directory=directory, num_pri=M, num_sec=X,
                                chunk_size=CHUNK, device="cpu", **kw)


def _drive_pre_crash(eng, tenants=3, rounds=3, hot=0):
    """Ragged appends with a hot tenant (secondary grants active), an
    engine-wide flush a round (a checkpoint at flush 2), then an unflushed,
    uncheckpointed ragged tail.  Returns the appended batches by tenant."""
    sids = {t: eng.open(f"t{t}") for t in range(tenants)}
    appended = {t: [] for t in sids}
    for r in range(rounds):
        for t in sids:
            b = _data(100 * r + t, (5 if t == hot else 1) * CHUNK + 37 * r + 11 * t)
            eng.append(sids[t], b)
            appended[t].append(b)
        eng.flush()
    for t in sids:
        b = _data(900 + t, CHUNK + 13 * t + 7)
        eng.append(sids[t], b)
        appended[t].append(b)
    eng._mgr.wait()
    return sids, appended


def _keys(batches):
    return [b[:, 0] for b in batches]


def _tenant_sids(eng):
    return {s.tenant: sid for sid, s in eng.sessions.items() if not s.closed}


def _engine_state(eng) -> dict:
    """What an uninterrupted engine and a recovered one must share."""
    return {"flush_no": eng._flush_no, "slot_sid": list(eng._slot_sid),
            "queue": list(eng._queue), "sec_assign": eng._sec_assign.tolist(),
            "next_sid": eng._next_sid,
            "backlogs": {sid: s.backlog_tuples for sid, s in eng.sessions.items()},
            "closed": {sid: s.closed for sid, s in eng.sessions.items()}}


# ------------------------------------------------------------------- WAL

def test_wal_roundtrip_global_order_and_seq_resume(tmp_path):
    wal = WriteAheadLog(tmp_path)
    payload = np.arange(7, dtype=np.int32).tobytes()
    wal.log("a", {"t": "open", "sid": 0, "tenant": "a"})
    wal.log("b", {"t": "open", "sid": 1, "tenant": "b"})
    wal.log("a", {"t": "app", "sid": 0, "dtype": "int32", "shape": [7]}, payload)
    wal.log("b", {"t": "close", "sid": 1})
    wal.close()
    wal2 = WriteAheadLog(tmp_path)
    recs = wal2.replay()
    assert [m["seq"] for m, _ in recs] == [1, 2, 3, 4]
    assert [m["t"] for m, _ in recs] == ["open", "open", "app", "close"]
    assert recs[2][1] == payload
    assert wal2.seq == 5
    assert len(list(tmp_path.glob("*.wal"))) == 2


def test_wal_torn_tail_tolerated_and_repaired(tmp_path):
    wal = WriteAheadLog(tmp_path)
    wal.log("a", {"t": "open", "sid": 0, "tenant": "a"})
    wal.log("a", {"t": "app", "sid": 0, "dtype": "int32", "shape": [2]},
            b"\x01\x00\x00\x00\x02\x00\x00\x00")
    wal.close()
    p = next(tmp_path.glob("*.wal"))
    good = p.stat().st_size
    with open(p, "ab") as f:
        f.write(b"\x99" * 11)
    wal2 = WriteAheadLog(tmp_path)
    assert len(wal2.replay()) == 2 and p.stat().st_size == good
    wal2.log("a", {"t": "close", "sid": 0})
    wal2.close()
    assert [m["t"] for m, _ in WriteAheadLog(tmp_path).replay()] == ["open", "app", "close"]


def test_wal_torn_header_truncates_to_empty_and_recovers(tmp_path):
    wal = WriteAheadLog(tmp_path)
    wal.log("a", {"t": "open", "sid": 0, "tenant": "a"})
    wal.close()
    p = next(tmp_path.glob("*.wal"))
    p.write_bytes(p.read_bytes()[:4])
    wal2 = WriteAheadLog(tmp_path)
    assert p.stat().st_size == 0
    s = wal2.log("a", {"t": "open", "sid": 0, "tenant": "a"})
    wal2.close()
    assert [m["seq"] for m, _ in WriteAheadLog(tmp_path).replay()] == [s]


def test_wal_watermark_filters_and_gc_drops_prefix(tmp_path):
    wal = WriteAheadLog(tmp_path)
    wal.log("a", {"t": "open", "sid": 0, "tenant": "a"})
    wal.log("a", {"t": "app", "sid": 0, "dtype": "int32", "shape": [0]})
    wm = wal.seq - 1
    wal.watermark(step=1, upto=wm)
    s3 = wal.log("a", {"t": "app", "sid": 0, "dtype": "int32", "shape": [0]})
    assert [m["seq"] for m, _ in wal.replay(after_seq=wm)] == [s3]
    assert wal.watermarks() == {1: wm}
    wal.gc(wm)
    assert [m["seq"] for m, _ in wal.replay()] == [s3]
    wal.close()


def test_wal_files_byte_identical_to_jax(tmp_path):
    """The same records through both packages' WriteAheadLog: the same
    file names and the same bytes, watermarks and GC included."""
    tenants = ["alpha", "b/eta ?", "", "x" * 60]
    for name, cls in (("jax", JWriteAheadLog), ("port", WriteAheadLog)):
        wal = cls(tmp_path / name)
        for i, t in enumerate(tenants):
            wal.log(t, {"t": "open", "sid": i, "tenant": t})
            a = np.arange(5 * i, dtype=np.int32).reshape(-1, 1)
            wal.log(t, {"t": "app", "sid": i, "dtype": str(a.dtype),
                        "shape": list(a.shape)}, a.tobytes())
        wal.watermark(step=1, upto=wal.seq - 1)
        wal.log(tenants[0], {"t": "close", "sid": 0})
        wal.gc(3)
        wal.close()
    jfiles = sorted(p.name for p in (tmp_path / "jax").glob("*.wal"))
    assert jfiles == sorted(p.name for p in (tmp_path / "port").glob("*.wal"))
    assert len(jfiles) == 4
    for name in jfiles:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    assert (tmp_path / "port" / jfiles[0]).read_bytes()[:8] == b"DWAL\x01\x00\x00\x00"


# -------------------------------------------------------- crash recovery

def test_crash_exact_local(tmp_path):
    eng = _engine(tmp_path)
    sids, appended = _drive_pre_crash(eng)
    assert (eng._sec_assign >= 0).any()
    total = sum(len(b) for bs in appended.values() for b in bs)
    eng2 = SessionEngine.recover(_spec(), tmp_path, device="cpu")
    info = eng2.recovery_info
    assert info["checkpoint_step"] is not None
    assert 0 < info["replayed_tuples"] < total and info["replay_anomalies"] == 0
    # 3 opens, 12 appends and 3 flush markers were logged in all
    assert 0 < info["replayed_records"] < 18
    by = _tenant_sids(eng2)
    for t in sids:
        np.testing.assert_array_equal(eng2.query(by[f"t{t}"]), _oracle(_keys(appended[t])))
    for t in sids:
        b = _data(500 + t, 2 * CHUNK + 5 * t)
        eng2.append(by[f"t{t}"], b)
        appended[t].append(b)
    eng2.flush()
    for t in sids:
        np.testing.assert_array_equal(eng2.close(by[f"t{t}"])[0],
                                      _oracle(_keys(appended[t])))
    eng2.shutdown()


def test_recovered_engine_equals_uninterrupted(tmp_path):
    """Against a live engine driven identically: equal answers, and -- the
    flush markers -- equal flush count, slot table, grants, backlogs and
    lane states."""
    eng = _engine(tmp_path / "crashed")
    sids, _ = _drive_pre_crash(eng)
    for t in sids:
        eng.query(sids[t], scope=("session", "engine")[t % 2])
    eng._mgr.wait()
    ref = _engine(tmp_path / "reference")
    _drive_pre_crash(ref)
    for t in sids:
        ref.query(sids[t], scope=("session", "engine")[t % 2])
    eng2 = SessionEngine.recover(_spec(), tmp_path / "crashed", device="cpu")
    assert _engine_state(eng2) == _engine_state(ref)
    from repro_torch.interop import state_to_numpy
    got, want = (state_to_numpy(e._lanes.gather_states(e._states)) for e in (eng2, ref))
    for k in ("buffers", "rr_base", "mode", "profile_hist", "chunks_in_mode"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for t in sids:
        np.testing.assert_array_equal(eng2.query(sids[t]), ref.query(sids[t]))
    eng2.shutdown()
    ref.shutdown()


def test_recover_without_checkpoint_replays_everything(tmp_path):
    eng = _engine(tmp_path, checkpoint_every=0)
    data = _data(1, 2 * CHUNK + 41)
    sid = eng.open("solo")
    eng.append(sid, data)
    eng.flush()
    eng2 = SessionEngine.recover(_spec(), tmp_path, device="cpu")
    assert eng2.recovery_info["checkpoint_step"] is None
    assert eng2.recovery_info["replayed_tuples"] == len(data)
    assert _engine_state(eng2) == _engine_state(eng)
    np.testing.assert_array_equal(eng2.query(_tenant_sids(eng2)["solo"]),
                                  _oracle(data[:, 0]))
    eng2.shutdown()


def test_storm_recovery_restores_backlogs(tmp_path):
    """The falsifying example of the JAX package's durable storm machine:
    ``open_batch(k=1, sizes=[128, 0]); recover()``.  The storm's admission
    flush ran the two full chunks; the JAX log holds only the open and the
    append, so its recovered engine has a backlog of 128 and one flush
    fewer.  The port's ``admit`` marker replays the admission flush."""
    kw = dict(primary_slots=2, secondary_slots=1, aot_buckets=2, checkpoint_every=2,
              keep=2)
    eng = _engine(tmp_path / "port", **kw)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, DOMAIN, size=128, dtype=np.int64)
    first = np.stack([keys, np.ones_like(keys)], axis=1).astype(np.int32)
    sids = eng.open_batch(["s0-0"], first=[first])
    assert eng.sessions[sids[0]].backlog_tuples == 0
    eng.shutdown()
    eng2 = SessionEngine.recover(_spec(), tmp_path / "port", device="cpu")
    assert eng2.sessions[sids[0]].backlog_tuples == 0
    assert _engine_state(eng2) == _engine_state(eng)
    assert eng2.recovery_info["replay_anomalies"] == 0
    np.testing.assert_array_equal(eng2.query(sids[0]), _oracle(first[:, 0]))
    eng2.shutdown()
    # the reference's behaviour on the same ops (ROADMAP §3): answers exact,
    # backlog and flush count not restored
    jeng = JDurableSessionEngine(jhisto.make_spec(BINS, DOMAIN, M),
                                 directory=tmp_path / "jax", num_pri=M, num_sec=X,
                                 chunk_size=CHUNK, **kw)
    jeng.open_batch(["s0-0"], first=[first])
    jeng.shutdown()
    jeng2 = JSessionEngine.recover(jhisto.make_spec(BINS, DOMAIN, M), tmp_path / "jax")
    assert jeng2.sessions[sids[0]].backlog_tuples == 128
    assert jeng2._flush_no == eng._flush_no - 1
    np.testing.assert_array_equal(np.asarray(jeng2.query(sids[0])), _oracle(first[:, 0]))
    jeng2.shutdown()


def test_flush_recovery_restores_backlogs(tmp_path):
    """The same fault with no storm: an engine flush, a per-session flush
    (query) and a close that no checkpoint covers all replay from their
    markers."""
    eng = _engine(tmp_path, checkpoint_every=0, secondary_slots=1)
    a, b, c = eng.open("a"), eng.open("b"), eng.open("c")
    eng.append(a, _data(1, 2 * CHUNK + 5))
    eng.append(b, _data(2, CHUNK + 43))
    eng.flush()
    eng.append(c, _data(3, 3 * CHUNK))
    eng.query(c)
    eng.close(b)
    eng.query(a, scope="engine")
    eng.shutdown()
    eng2 = SessionEngine.recover(_spec(), tmp_path, device="cpu")
    assert _engine_state(eng2) == _engine_state(eng)
    kinds = [m["t"] for m, _ in eng2._wal.replay()]
    assert kinds.count("flush") == 2 and kinds.count("fsess") == 1 and "close" in kinds
    eng2.shutdown()


def test_corrupt_latest_checkpoint_falls_back(tmp_path):
    eng = _engine(tmp_path, checkpoint_every=0)
    sid = eng.open("solo")
    chunks = []
    for r in range(3):
        b = _data(40 + r, 2 * CHUNK + 19 * r)
        eng.append(sid, b)
        chunks.append(b)
        eng.flush()
        eng.checkpoint(block=True)
    steps = eng._mgr.steps()
    assert len(steps) == 3
    leaf = tmp_path / "ckpt" / f"step_{steps[-1]}" / "leaf_0.npy"
    leaf.write_bytes(leaf.read_bytes()[:10])
    with pytest.warns(UserWarning, match="skipping unreadable"):
        eng2 = SessionEngine.recover(_spec(), tmp_path, device="cpu")
    assert eng2.recovery_info["checkpoint_step"] == steps[-2]
    assert eng2.recovery_info["replayed_tuples"] == len(chunks[-1])
    np.testing.assert_array_equal(eng2.query(_tenant_sids(eng2)["solo"]),
                                  _oracle(_keys(chunks)))
    eng2.shutdown()


def test_all_checkpoints_corrupt_refuses_wal_only_recovery(tmp_path):
    eng = _engine(tmp_path, checkpoint_every=0)
    sid = eng.open("solo")
    eng.append(sid, _data(1, 2 * CHUNK))
    eng.flush()
    eng.checkpoint(block=True)
    for step_dir in (tmp_path / "ckpt").glob("step_*"):
        (step_dir / "leaf_0.npy").write_bytes(b"garbage")
    with pytest.warns(UserWarning, match="skipping unreadable"):
        with pytest.raises(RuntimeError, match="WAL-only"):
            SessionEngine.recover(_spec(), tmp_path, device="cpu")


def test_wal_gc_runs_in_steady_state(tmp_path):
    eng = _engine(tmp_path, checkpoint_every=1, keep=1)
    sid = eng.open("solo")
    chunks = []
    for r in range(4):
        b = _data(60 + r, 2 * CHUNK + 19 * r)
        eng.append(sid, b)
        chunks.append(b)
        eng.flush()
    eng._mgr.wait()
    replayable = eng._wal.replay()
    assert all(m["seq"] > 2 for m, _ in replayable)
    assert len([m for m, _ in replayable if m["t"] == "app"]) < len(chunks)
    eng2 = SessionEngine.recover(_spec(), tmp_path, device="cpu")
    np.testing.assert_array_equal(eng2.query(_tenant_sids(eng2)["solo"]),
                                  _oracle(_keys(chunks)))
    eng2.shutdown()


def test_queued_and_empty_sessions_survive(tmp_path):
    eng = _engine(tmp_path, primary_slots=1, secondary_slots=0)
    a = eng.open("first")
    b = eng.open("waiting")
    c_data = _data(7, CHUNK + 9)
    eng.append(b, c_data)
    empty = eng.open("empty")
    eng.append(empty, np.zeros((0, 2), np.int32))
    eng.flush()
    eng.checkpoint(block=True)
    eng2 = SessionEngine.recover(_spec(), tmp_path, device="cpu")
    by = _tenant_sids(eng2)
    assert eng2.sessions[by["waiting"]].slot is None
    with pytest.raises(RuntimeError, match="queued"):
        eng2.query(by["waiting"])
    eng2.close(by["first"])
    np.testing.assert_array_equal(eng2.query(by["waiting"]), _oracle(c_data[:, 0]))
    merged, stats = eng2.close(by["waiting"])
    eng2.close(by["empty"])
    assert stats["tuples_appended"] == len(c_data)
    assert a == 0 and empty == 2
    eng2.shutdown()


def test_fresh_engine_refuses_stale_dir(tmp_path):
    eng = _engine(tmp_path)
    sid = eng.open()
    eng.append(sid, _data(1, 64, 0.0))
    eng.shutdown()
    with pytest.raises(ValueError, match="recover"):
        _engine(tmp_path)
    eng2 = _engine(tmp_path, overwrite=True)
    assert eng2._wal.replay() == []
    eng2.shutdown()


def test_drain_then_recover_with_empty_tail(tmp_path):
    guard = PreemptionGuard(signals=())
    eng = _engine(tmp_path, guard=guard)
    sid = eng.open("alpha")
    data = _data(1, 3 * CHUNK + 7)
    eng.append(sid, data)
    guard.trigger()
    with pytest.raises(EnginePreempted):
        eng.append(sid, data)
    assert eng.drained
    np.testing.assert_array_equal(eng.query(sid), _oracle(data[:, 0]))
    np.testing.assert_array_equal(eng.query(sid, scope="engine"), _oracle(data[:, 0]))
    with pytest.raises(EnginePreempted):
        eng.open("beta")
    eng2 = SessionEngine.recover(_spec(), tmp_path, device="cpu")
    assert eng2.recovery_info["replayed_records"] == 0
    np.testing.assert_array_equal(eng2.query(_tenant_sids(eng2)["alpha"]),
                                  _oracle(data[:, 0]))
    eng2.shutdown()


def test_no_crash_answers_identical_to_plain(tmp_path):
    engines = {"plain": SessionEngine(_spec(), num_pri=M, num_sec=X, chunk_size=CHUNK,
                                      primary_slots=2, secondary_slots=2, device="cpu"),
               "durable": _engine(tmp_path, primary_slots=2)}
    answers = {}
    for name, eng in engines.items():
        sids = {t: eng.open(f"t{t}") for t in range(2)}
        out = []
        for r in range(3):
            for t in sids:
                eng.append(sids[t], _data(10 * r + t, (4 if t == 0 else 1) * CHUNK + 31 * r))
            eng.flush()
            out.append(eng.query(sids[0]))
        for t in sids:
            out.append(eng.close(sids[t])[0])
        rows = [{k: v for k, v in r.items() if not k.endswith("ms")} for r in eng._telemetry]
        answers[name] = (out, rows)
    for got, want in zip(answers["durable"][0], answers["plain"][0]):
        np.testing.assert_array_equal(got, want)
    assert answers["durable"][1] == answers["plain"][1]
    engines["durable"].shutdown()


def test_recover_lands_in_same_buckets_zero_builds(tmp_path):
    eng = _engine(tmp_path, aot_buckets=2)
    sids, appended = _drive_pre_crash(eng, tenants=2)
    eng.shutdown()
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["engine_kw"]["aot_buckets"] == 2
    assert "kernel_backend" not in cfg["engine_kw"] and "device" not in cfg["engine_kw"]
    eng2 = SessionEngine.recover(_spec(), tmp_path, device="cpu")
    rec = eng2.telemetry_record(validate=False)
    assert rec["extra"]["config"]["aot_buckets"] == 2 and rec["extra"]["aot"] is not None
    n0 = len(rec["rows"])
    before = compilemon.snapshot()
    by = _tenant_sids(eng2)
    for t in sids:
        np.testing.assert_array_equal(eng2.query(by[f"t{t}"]), _oracle(_keys(appended[t])))
    assert compilemon.since(before).n_compiles == 0
    steady = eng2.telemetry_record(validate=False)["rows"][n0:]
    assert steady and all(r["n_retraces"] == 0 for r in steady)
    eng2.shutdown()
    plain = _engine(tmp_path / "plain")
    _drive_pre_crash(plain, tenants=2)
    plain.shutdown()
    rec = SessionEngine.recover(_spec(), tmp_path / "plain", device="cpu") \
        .telemetry_record(validate=False)
    assert rec["extra"]["config"]["aot_buckets"] is None and rec["extra"]["aot"] is None


def test_crash_mid_storm_replays_the_rest(tmp_path):
    eng = _engine(tmp_path, primary_slots=3, secondary_slots=1, aot_buckets=2,
                  checkpoint_every=0)
    warm_data = _data(1, 2 * CHUNK + 31)
    warm = eng.open("warm")
    eng.append(warm, warm_data)
    eng.flush()
    eng.checkpoint(block=True)
    tenants = [f"s{i}" for i in range(5)]
    firsts = [_data(10 + i, CHUNK * (1 + i % 3) + 17 * i, (0.0, 1.5)[i % 2])
              for i in range(4)] + [None]
    sids = eng.open_batch(tenants, first=firsts)
    assert [eng.sessions[s].slot is not None for s in sids] == [True, True, False, False,
                                                                 False]
    crashed = _engine_state(eng)
    eng2 = SessionEngine.recover(_spec(), tmp_path, device="cpu")
    info = eng2.recovery_info
    assert info["checkpoint_step"] is not None and info["replay_anomalies"] == 0
    assert info["replayed_tuples"] == sum(len(f) for f in firsts if f is not None)
    assert _engine_state(eng2) == crashed
    by = _tenant_sids(eng2)
    for i in (0, 1):
        np.testing.assert_array_equal(eng2.query(by[tenants[i]]), _oracle(firsts[i][:, 0]))
    for t in ("warm", *tenants[:2]):
        eng2.close(by[t])
    for i in (2, 3):
        np.testing.assert_array_equal(eng2.query(by[tenants[i]]), _oracle(firsts[i][:, 0]))
    assert all(r["n_retraces"] == 0 for r in eng2._telemetry)
    eng2.shutdown()


def test_recover_refusals(tmp_path):
    eng = _engine(tmp_path)
    eng.shutdown()
    from repro_torch.core.distributed import make_mesh
    with pytest.raises(ValueError, match="mesh has no 'lanes' axis"):
        recover(_spec(), tmp_path, mesh=make_mesh(1, "pe", device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="must be divisible"):
        recover(_spec(), tmp_path, mesh=make_mesh(7, "lanes", device="cpu"), device="cpu")
    from repro_torch.apps import hll
    with pytest.raises(ValueError, match="serving app"):
        recover(hll.make_spec(8, M), tmp_path, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            recover(_spec(), tmp_path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            recover(_spec(), tmp_path, mesh=make_mesh(5, "lanes"))


# ------------------------------------------------------------ across packages

def _jax_engine(directory, **kw):
    return JDurableSessionEngine(jhisto.make_spec(BINS, DOMAIN, M), directory=directory,
                                 num_pri=M, num_sec=X, chunk_size=CHUNK, primary_slots=3,
                                 secondary_slots=2, checkpoint_every=2, **kw)


def test_jax_directory_recovers_in_the_port(tmp_path):
    """A directory JAX's durable engine wrote (checkpoint + WAL tail, a
    ``kernel_backend`` in its config), abandoned mid-stream, recovers in
    the port with answers equal to JAX's uninterrupted engine."""
    jeng = _jax_engine(tmp_path / "jax", kernel_backend="jnp")
    sids, appended = _drive_pre_crash(jeng)
    assert json.loads((tmp_path / "jax" / "config.json").read_text())["engine_kw"] \
        == {"kernel_backend": "jnp"}
    ref = _jax_engine(tmp_path / "ref")
    _drive_pre_crash(ref)
    eng2 = SessionEngine.recover(_spec(), tmp_path / "jax", device="cpu")
    assert eng2.recovery_info["checkpoint_step"] is not None
    assert eng2.recovery_info["replay_anomalies"] == 0
    for t in sids:
        want = np.asarray(ref.query(sids[t]))
        np.testing.assert_array_equal(eng2.query(sids[t]), want)
        np.testing.assert_array_equal(want, _oracle(_keys(appended[t])))
    eng2.shutdown()
    ref.shutdown()


def test_port_directory_recovers_in_jax(tmp_path):
    """A directory the port wrote (its marker records included: JAX's replay
    skips a record type it does not know) recovers in the JAX package with
    answers equal to the port's uninterrupted engine."""
    eng = _engine(tmp_path / "port")
    sids, appended = _drive_pre_crash(eng)
    eng.open_batch(["storm-a", "storm-b"], first=[_data(70, 2 * CHUNK + 3), None])
    eng.query(sids[1])
    kinds = {m["t"] for m, _ in eng._wal.replay()}
    assert {"admit", "fsess"} <= kinds
    ref = _engine(tmp_path / "ref")
    _drive_pre_crash(ref)
    ref.open_batch(["storm-a", "storm-b"], first=[_data(70, 2 * CHUNK + 3), None])
    jeng = JSessionEngine.recover(jhisto.make_spec(BINS, DOMAIN, M), tmp_path / "port")
    assert jeng.recovery_info["checkpoint_step"] is not None
    assert jeng.recovery_info["replay_anomalies"] == 0
    for sid in [*sids.values(), *_tenant_sids(ref).values()]:
        if ref.sessions[sid].slot is not None:
            np.testing.assert_array_equal(np.asarray(jeng.query(sid)), ref.query(sid))
    jeng.shutdown()
    ref.shutdown()
