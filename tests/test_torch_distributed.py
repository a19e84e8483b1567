"""The port's multi-device layer (``repro_torch.core.distributed``,
``core.router.route_all_to_all``, ``SessionEngine(mesh=...)`` and
``recover(..., mesh=...)``) on meshes of CPU shards, every state bit-exact.

The JAX package's mesh paths run under several host devices only in a
process of their own, and some of them fail under the installed JAX
(ROADMAP §3): ``run_stream``'s merger, ``route_all_to_all`` at any mesh
larger than 1, and the lane-sharded executor's ``run_lanes``.  So the
tests hold the port against what still runs there and against oracles for
the rest:

  * the PE-sharded chunk step: one subprocess (8 host devices, built once a
    session) drives ``repro.core.distributed.make_distributed_executor``'s
    chunk step over the chunks and replicates ``run_stream``'s host loop in
    numpy; the port's ``run_stream`` on 8 CPU shards equals it chunk by
    chunk (buffers, loads, drops, workload) and at the end;
  * the cluster-scale claim of ``examples/distributed_ditto.py`` at its own
    configuration;
  * ``route_all_to_all`` against JAX's at a mesh of 1 and against a numpy
    oracle of its docstring at 2, 4 and 8 shards;
  * the lane-sharded executor at meshes of 1, 2 and 4 against JAX's local
    ``vmap(res.scan_chunks)`` and the port's unsharded ``scan_lanes``;
  * a meshed port ``SessionEngine`` against JAX's local engine op by op
    (``Twin``), a Hypothesis run of the storm machine on a meshed engine,
    and checkpoints across local and meshed engines of both packages.
"""
from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from repro.apps import dp as jdp
from repro.apps import histo as jhisto
from repro.core import executor as jexecutor
from repro.core import router as jrouter
from repro_torch.apps import dp, histo, hll
from repro_torch.core import distributed as D
from repro_torch.core import executor
from repro_torch.core.router import route_all_to_all
from repro_torch.data.zipf import zipf_tuples
from repro_torch.serve import SessionEngine, recover
from tests.conftest import SMALL_CHUNK, SMALL_M
from tests.test_torch_session import _dp_state_eq
from tests.test_torch_stream import _tree_eq

# ------------------------------------------------ the PE-sharded chunk step

P, PRI, T_LOC, K, DOMAIN = 8, 6, 256, 6, 1 << 16
CAP = T_LOC // 3                   # a third of the uniform share a pair
CASES = [("histo", a, x) for a in (0.0, 2.0) for x in (0, 2)] + [("hll", 2.0, 2)]

_JAX_CHUNK_STEP = textwrap.dedent(f"""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.apps import histo, hll
    from repro.core import distributed as D, mapper, scheduler
    from repro.data.zipf import zipf_tuples
    P, M, T_LOC, K, DOMAIN, CAP = {P}, {PRI}, {T_LOC}, {K}, {DOMAIN}, {CAP}
    mesh = jax.make_mesh((P,), ("pe",))
    out = {{}}
    for app, alpha, x in {CASES!r}:
        spec = histo.make_spec(64, DOMAIN, M) if app == "histo" else hll.make_spec(8, M)
        data = zipf_tuples(P * T_LOC * K, DOMAIN, alpha, seed=11).reshape(K, P * T_LOC, 2)
        step = D.make_distributed_executor(spec, mesh, M, x, capacity=CAP)
        buffers, plan = spec.init_buffer(P), mapper.init_plan(M, x)
        hist = jnp.zeros((M,), jnp.int32)
        assignment = jnp.full((x,), -1, jnp.int32)
        rec = {{k: [] for k in ("buffers", "loads", "drops", "workload")}}
        for c in range(K):          # run_stream's host loop (profile_chunks=1)
            outs = step(jnp.asarray(data[c]), buffers, plan.table, plan.counter)
            buffers, workload = outs[0], outs[3]
            for k, v in zip(rec, outs):
                rec[k].append(np.asarray(v))
            hist = hist + workload
            if c == 0 and x:
                assignment = scheduler.schedule_secpes(hist, x)
                plan = mapper.apply_schedule(mapper.init_plan(M, x), assignment)
        b, merged = np.asarray(buffers), np.asarray(buffers)[:M].copy()
        for j, tgt in enumerate(np.asarray(assignment)):      # the merger
            if tgt >= 0:
                merged[tgt] = (merged[tgt] + b[M + j] if spec.combine == "add"
                               else np.maximum(merged[tgt], b[M + j]))
        name = f"{{app}}_{{alpha}}_{{x}}"
        for k, v in rec.items():
            out[name + "/" + k] = np.stack(v)
        out[name + "/merged"], out[name + "/assignment"] = merged, np.asarray(assignment)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="session")
def jax_chunk_steps(tmp_path_factory, cpu_mesh_env):
    """JAX's chunk step per chunk for every case of CASES, on 8 host
    devices in a subprocess (its own ``run_stream`` fails at the merger)."""
    path = tmp_path_factory.mktemp("jax_distributed") / "ref.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_CHUNK_STEP, str(path)],
                       env=cpu_mesh_env, capture_output=True, text=True, timeout=300,
                       cwd=str(REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(path))


def _spec(app):
    return histo.make_spec(64, DOMAIN, PRI) if app == "histo" else hll.make_spec(8, PRI)


@pytest.mark.parametrize("app,alpha,x", CASES)
def test_run_stream_equals_jax_chunk_step(jax_chunk_steps, app, alpha, x):
    ref = {k.split("/")[1]: v for k, v in jax_chunk_steps.items()
           if k.startswith(f"{app}_{alpha}_{x}/")}
    data = zipf_tuples(P * T_LOC * K, DOMAIN, alpha, seed=11).reshape(K, P * T_LOC, 2)
    got = {k: [] for k in ("buffers", "loads", "drops", "workload")}

    def on_chunk(c, buffers, load, dropped, workload):
        for k, v in zip(got, (torch.cat(buffers), load, dropped, workload)):
            got[k].append(v.numpy().copy())

    mesh = D.make_mesh(P, "pe", device="cpu")
    merged, stats = D.run_stream(_spec(app), mesh, data, PRI, x, capacity=CAP,
                                 on_chunk=on_chunk)
    for k, v in got.items():
        np.testing.assert_array_equal(np.stack(v), ref[k], err_msg=k)
    np.testing.assert_array_equal(merged.numpy(), ref["merged"])
    np.testing.assert_array_equal(stats["assignment"].numpy(), ref["assignment"])
    assert stats["dropped"] == int(ref["drops"].sum())
    assert stats["loads"] == ref["loads"].max(axis=1).tolist()
    if stats["dropped"] == 0:
        keys = data.reshape(-1, 2)[:, 0]
        want = (histo.oracle(keys, 64, DOMAIN, PRI) if app == "histo"
                else hll.oracle(keys, 8, PRI))
        np.testing.assert_array_equal(merged.numpy(), want)
    if alpha and x:
        assert stats["dropped_postplan"] < stats["dropped"]


def test_cluster_scale_claim():
    """``examples/distributed_ditto.py``'s configuration (384 bins over
    2^20 keys, 6 + 2 shards, 16 chunks of 6144, capacity 256): at alpha 2
    X = 0 drops more than 1000 tuples, X = 2 drops none after the plan at a
    lower max receive load; both alpha-0 runs are oracle-exact."""
    bins, domain, chunk, n = 384, 1 << 20, 6144, 16
    spec = histo.make_spec(bins, domain, 6)
    mesh = D.make_mesh(8, "pe", device="cpu")
    runs = {}
    for alpha in (0.0, 2.0):
        data = zipf_tuples(chunk * n, domain, alpha, seed=3).reshape(n, chunk, 2)
        for sec in (0, 2):
            merged, stats = D.run_stream(spec, mesh, data, 6, sec, capacity=chunk // 8 // 3)
            runs[alpha, sec] = stats
            if alpha == 0.0:
                assert stats["dropped"] == 0
                np.testing.assert_array_equal(
                    merged.numpy(), histo.oracle(data.reshape(-1, 2)[:, 0], bins, domain, 6))
    assert runs[2.0, 0]["dropped_postplan"] > 1000
    assert runs[2.0, 2]["dropped_postplan"] == 0
    assert runs[2.0, 2]["max_load_postplan"] < runs[2.0, 0]["max_load_postplan"]


def test_mesh_and_collectives():
    mesh = D.make_mesh(3, "pe", device="cpu")
    assert dict(mesh.shape) == {"pe": 3} and mesh.size == 3
    assert D.make_mesh(2, "x", devices=["cpu", torch.device("cpu")]).devices \
        == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="devices for"):
        D.make_mesh(3, "x", devices=["cpu"])
    with pytest.raises(ValueError, match="at least one shard"):
        D.make_mesh(0, "x", device="cpu")
    send = [torch.arange(6).view(3, 2) + 10 * s for s in range(3)]
    recv = D.all_to_all(send, mesh.devices)
    for d in range(3):
        for s in range(3):
            assert torch.equal(recv[d][s], send[s][d])
    xs = [torch.tensor([1, 2]), torch.tensor([3, 4]), torch.tensor([5, 6])]
    assert torch.equal(D.psum(xs, torch.device("cpu")), torch.tensor([9, 12]))
    assert all(torch.equal(t, torch.tensor([9, 12])) for t in D.psum(xs, mesh.devices))
    with pytest.raises(ValueError, match="need as many shards"):
        D.make_distributed_executor(_spec("histo"), mesh, 3, 1, capacity=4)
    with pytest.raises(KeyError, match="no 'pe' axis"):
        D.make_distributed_executor(_spec("histo"), D.make_mesh(8, "x", device="cpu"),
                                    PRI, 2, capacity=4)


# --------------------------------------------------------- route_all_to_all

def _route_oracle(tuples, dst_eff, num_pe, capacity, shards, fill):
    """The docstring's semantics in numpy: per (destination, source) shard,
    the source's tuples for that destination in stream order, the first
    ``capacity`` kept."""
    t_loc, per = len(tuples) // shards, num_pe // shards
    routed = np.full((shards, shards, capacity) + tuples.shape[1:], fill, tuples.dtype)
    valid = np.zeros((shards, shards, capacity), bool)
    dropped = 0
    for s in range(shards):
        for i in range(s * t_loc, (s + 1) * t_loc):
            d = int(dst_eff[i]) // per
            if not 0 <= d < shards:
                dropped += 1
                continue
            k = int(valid[d, s].sum())
            if k < capacity:
                routed[d, s, k], valid[d, s, k] = tuples[i], True
            else:
                dropped += 1
    return routed, valid, dropped


def test_route_all_to_all_mesh_of_1_equals_jax():
    rng = np.random.default_rng(0)
    tup = rng.integers(0, 100, size=(96, 3)).astype(np.int32)
    eff = rng.integers(0, 4, size=96).astype(np.int32)
    jr, jv = jrouter.route_all_to_all(jnp.asarray(tup), jnp.asarray(eff), 4, 96,
                                      jax.make_mesh((1,), ("model",)))
    routed, valid = route_all_to_all(torch.as_tensor(tup), torch.as_tensor(eff), 4, 96,
                                     D.make_mesh(1, "model", device="cpu"))
    np.testing.assert_array_equal(routed[0].numpy(), np.asarray(jr))
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jv))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_route_all_to_all_oracle(shards):
    rng = np.random.default_rng(shards)
    n, num_pe, cap = 48 * shards, 2 * shards, 9
    tup = rng.integers(-50, 50, size=(n, 2)).astype(np.int32)
    # skewed destinations, so some bins overflow; a few out of range
    eff = np.minimum(rng.zipf(1.6, size=n) - 1, num_pe).astype(np.int32)
    mesh = D.make_mesh(shards, "model", device="cpu")
    routed, valid = route_all_to_all(torch.as_tensor(tup), torch.as_tensor(eff), num_pe,
                                     cap, mesh, fill_value=-7)
    want_r, want_v, dropped = _route_oracle(tup, eff, num_pe, cap, shards, -7)
    assert dropped > 0
    for d in range(shards):
        np.testing.assert_array_equal(routed[d].numpy(), want_r[d])
        np.testing.assert_array_equal(valid[d].numpy(), want_v[d])
    assert n - sum(int(v.sum()) for v in valid) == dropped
    with pytest.raises(ValueError, match="do not split"):
        route_all_to_all(torch.as_tensor(tup[:-1]), torch.as_tensor(eff[:-1]), num_pe,
                         cap, mesh)


# ------------------------------------------------ the lane-sharded executor

NUM_LANES = 4


def _lane_pair():
    res = executor.make_resumable_executor(histo.make_spec(64, DOMAIN, SMALL_M), SMALL_M,
                                           2, SMALL_CHUNK, device="cpu")
    jres = jexecutor.make_resumable_executor(jhisto.make_spec(64, DOMAIN, SMALL_M), SMALL_M,
                                             2, SMALL_CHUNK)
    return res, jres


def _lane_chunks(zipf_dataset):
    data = np.stack([zipf_dataset(2 * SMALL_CHUNK, DOMAIN, 0.5 * ln, seed=ln)
                     .reshape(2, SMALL_CHUNK, 2) for ln in range(NUM_LANES)])
    mask = np.ones(data.shape[:3], bool)
    mask[1, 1, 40:] = False            # one ragged lane
    return data, mask


@pytest.mark.parametrize("shards", [1, 2, 4])
class TestShardedLaneExecutor:
    """The four cases of ``tests/test_distributed.py``'s class on the port
    at meshes of 1, 2 and 4 CPU shards, plus DP lanes and the gathers."""

    def _build(self, shards):
        res, jres = _lane_pair()
        sh = D.make_lane_sharded_executor(res, D.make_mesh(shards, "lanes", device="cpu"),
                                          NUM_LANES)
        return res, jres, sh

    def test_run_lanes_matches_local_vmap(self, shards, zipf_dataset):
        res, jres, sh = self._build(shards)
        chunks, mask = _lane_chunks(zipf_dataset)
        states, stats = sh.run_lanes(sh.init_states(), chunks, mask)
        assert len(states) == shards
        assert all(s.mode.shape == (NUM_LANES // shards,) for s in states)
        got = sh.gather_states(states)
        jstates, jstats = jax.jit(jax.vmap(jres.scan_chunks))(
            jexecutor.stack_states(jres.init_state(), NUM_LANES), jnp.asarray(chunks),
            jnp.asarray(mask))
        _tree_eq(got, jstates)
        _tree_eq(stats, jstats)
        want, wstats = res.scan_lanes(executor.stack_states(res.init_state(), NUM_LANES),
                                      chunks, mask)
        _tree_eq(got, want)
        _tree_eq(stats, wstats)

    def test_merge_and_reset_match_indexed(self, shards, zipf_dataset):
        res, _, sh = self._build(shards)
        states, _ = sh.run_lanes(sh.init_states(), *_lane_chunks(zipf_dataset))
        whole = sh.gather_states(states)
        for i in range(NUM_LANES):
            want = res.merge_state(executor.take_lanes(whole, i))
            assert torch.equal(sh.merge_lane(states, i), want)
        reset = sh.gather_states(sh.reset_lane(states, 2))
        _tree_eq(executor.take_lanes(reset, 2), res.init_state())
        for lane in (0, 1, 3):             # other lanes untouched
            _tree_eq(executor.take_lanes(reset, lane), executor.take_lanes(whole, lane))
        _tree_eq(sh.gather_states(states), whole)      # the input stays as it was

    def test_fold_lane_is_merge_before_reassign(self, shards, zipf_dataset):
        """fold(src, dst) adds src's merged contribution into dst's PriPE
        rows, then resets src; at 2 and 4 shards src and dst live on
        different shards."""
        res, _, sh = self._build(shards)
        states, _ = sh.run_lanes(sh.init_states(), *_lane_chunks(zipf_dataset))
        src, dst = 3, 0
        assert (sh.lane_sharding[src] != sh.lane_sharding[dst]) == (shards > 1)
        contrib = sh.merge_lane(states, src)
        folded = sh.fold_lane(states, src, dst)
        whole = sh.gather_states(states)
        want = whole.buffers[dst].clone()
        want[:SMALL_M] += contrib
        got = sh.gather_states(folded)
        assert torch.equal(got.buffers[dst], want)
        _tree_eq(executor.take_lanes(got, src), res.init_state())
        total = sum(int(sh.merge_lane(folded, i).sum()) for i in range(NUM_LANES))
        assert total == sum(int(sh.merge_lane(states, i).sum()) for i in range(NUM_LANES))

    def test_missing_axis_and_lane_split(self, shards):
        res, _ = _lane_pair()
        with pytest.raises(KeyError):
            D.make_lane_sharded_executor(res, D.make_mesh(shards, "pe", device="cpu"), 4,
                                         axis="lanes")
        if shards > 1:             # every lane count splits over one shard
            with pytest.raises(ValueError, match="must be divisible"):
                D.make_lane_sharded_executor(
                    res, D.make_mesh(shards, "lanes", device="cpu"), shards * 4 + 1)
        sh = D.make_lane_sharded_executor(res, D.make_mesh(shards, "lanes", device="cpu"), 4)
        assert sh.lanes_per_device == 4 // shards
        assert sh.lane_sharding == tuple(g // (4 // shards) for g in range(4))

    def test_take_put_shard_gather(self, shards, zipf_dataset):
        res, _, sh = self._build(shards)
        states, _ = sh.run_lanes(sh.init_states(), *_lane_chunks(zipf_dataset))
        whole = sh.gather_states(states)
        idx = [3, 0, 2]
        sub = sh.take_lanes(states, idx)
        _tree_eq(sub, executor.take_lanes(whole, idx))
        _tree_eq(sh.take_lanes(states, 1), executor.take_lanes(whole, 1))
        put = sh.put_lanes(states, [1, 2, 0], sub)
        _tree_eq(sh.gather_states(put), executor.put_lanes(whole, [1, 2, 0], sub))
        _tree_eq(sh.gather_states(sh.shard_states(whole)), whole)

    def test_dp_lanes(self, shards):
        """DP (its own merge, its update over the lanes axis) through
        run_lanes and merge_lane, against JAX's local vmap."""
        res = executor.make_resumable_executor(dp.make_spec(3, SMALL_M, 256), SMALL_M, 2,
                                               SMALL_CHUNK, device="cpu")
        jres = jexecutor.make_resumable_executor(jdp.make_spec(3, SMALL_M, 256), SMALL_M, 2,
                                                 SMALL_CHUNK)
        sh = D.make_lane_sharded_executor(res, D.make_mesh(shards, "lanes", device="cpu"),
                                          NUM_LANES)
        chunks = np.stack([zipf_tuples(2 * SMALL_CHUNK, 1 << 12, 0.8 * ln, seed=40 + ln)
                           .reshape(2, SMALL_CHUNK, 2) for ln in range(NUM_LANES)])
        mask = np.ones(chunks.shape[:3], bool)
        mask[2, 1, 100:] = False
        states, _ = sh.run_lanes(sh.init_states(), chunks, mask)
        jstates, _ = jax.vmap(jres.scan_chunks)(
            jexecutor.stack_states(jres.init_state(), NUM_LANES), jnp.asarray(chunks),
            jnp.asarray(mask))
        _dp_state_eq(sh.gather_states(states), jstates)
        for i in range(NUM_LANES):
            got = sh.merge_lane(states, i)
            want = jres.merge_state(jax.tree.map(lambda x: x[i], jstates))
            for f in want._fields:
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              np.asarray(getattr(want, f)), err_msg=f)
        with pytest.raises(ValueError, match="cannot be folded"):
            sh.fold_lane(states, 1, 0)


# ------------------------------------------------------------ SessionEngine

from tests.test_torch_session import (BINS, CHUNK, M, Twin, _data,  # noqa: E402
                                      _oracle)


@pytest.mark.parametrize("aot", [None, 2])
def test_meshed_engine_equals_jax_local(aot):
    """6 + 2 slots over 4 CPU shards (2 lanes a shard) against JAX's local
    engine: ragged appends, one hot tenant whose grants move, both query
    scopes, engine and per-session flushes, closes; answers, slot tables,
    grants, integer telemetry and Prometheus series equal after every op,
    and some secondary lane folds across shards."""
    tw = Twin(primary_slots=6, secondary_slots=2, aot_buckets=aot,
              mesh=D.make_mesh(4, "lanes", device="cpu"))
    assert tw.p.lanes_per_device == 2
    folds = []
    fold = tw.p._fold_lane

    def spy(states, src, dst):
        folds.append((tw.p._lanes.lane_sharding[src], tw.p._lanes.lane_sharding[dst]))
        return fold(states, src, dst)

    tw.p._fold_lane = spy
    rng = np.random.default_rng(7)
    sids = {t: tw.open(f"t{t}") for t in range(6)}
    keys = {t: [] for t in sids}
    for r in range(4):
        hot = r % 2
        for t in sids:
            n = (6 if t == hot else 1) * CHUNK + int(rng.integers(1, CHUNK))
            batch = _data(100 * r + t, n, 1.5)
            tw.append(sids[t], batch)
            keys[t].append(batch[:, 0])
        tw.flush()
        for t in (hot, 2 + r % 4):
            np.testing.assert_array_equal(
                tw.query(sids[t], scope=("session", "engine")[r % 2]), _oracle(keys[t]))
        tw.flush_session(sids[5])
    assert tw.p.slot_reschedules > 0
    assert any(a != b for a, b in folds), folds
    late = tw.open("late")                      # queued: all 6 slots busy
    for t in sids:
        merged, _ = tw.close(sids[t])
        np.testing.assert_array_equal(merged, _oracle(keys[t]))
    tw.append(late, _data(77, CHUNK + 5))
    tw.close(late)
    rec = tw.p.telemetry_record()["extra"]["config"]
    assert (rec["mesh_devices"], rec["lanes_per_device"]) == (4, 2)


def test_meshed_engine_random_walk():
    """The differential random walk of ``test_torch_session.py`` on a port
    engine over 3 CPU shards (2 + 1 slots, a lane a shard)."""
    from tests.test_torch_session import AOT, _walk
    _walk(Twin(aot_buckets=AOT, mesh=D.make_mesh(3, "lanes", device="cpu")),
          seed=20261018, n_ops=40)


try:
    from hypothesis import HealthCheck, settings
    from hypothesis.stateful import run_state_machine_as_test
    from tests.test_torch_session import _PortStorm
    HAVE_HYPOTHESIS = True
except ImportError:                       # pragma: no cover
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    class _MeshStorm(_PortStorm):
        durable = True
        mesh = D.make_mesh(3, "lanes", device="cpu")

    def test_stateful_machine_meshed_durable():
        """The storm machine of ``test_torch_session.py`` on a durable port
        engine over 3 CPU shards, recovered onto the mesh."""
        run_state_machine_as_test(_MeshStorm, settings=settings(
            max_examples=15, stateful_step_count=15, deadline=None, database=None,
            suppress_health_check=list(HealthCheck)))


def test_meshed_engine_device_checks():
    spec = histo.make_spec(BINS, 1 << 12, M)
    eng = SessionEngine(spec, num_pri=M, num_sec=2, chunk_size=CHUNK, primary_slots=2,
                        secondary_slots=2, mesh=D.make_mesh(2, "lanes", device="cpu"),
                        device="cpu")
    assert eng.device == torch.device("cpu") and len(eng._states) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SessionEngine(spec, num_pri=M, num_sec=2, chunk_size=CHUNK, primary_slots=2,
                          secondary_slots=2, mesh=D.make_mesh(2, "lanes", device="cpu"))


# ------------------------------------------------------- durability, meshes

from tests.test_torch_durability import (_drive_pre_crash, _engine,  # noqa: E402
                                         _engine_state, _jax_engine, _keys,
                                         _tenant_sids)
from tests.test_torch_durability import _oracle as _doracle  # noqa: E402
from tests.test_torch_durability import _spec as _dspec  # noqa: E402


def _five():
    """3 + 2 slots: a lane a shard."""
    return D.make_mesh(5, "lanes", device="cpu")


def _check_recovered(eng2, sids, appended, ref=None):
    by = _tenant_sids(eng2)
    if ref is not None:
        assert _engine_state(eng2) == _engine_state(ref)
    for t in sids:
        np.testing.assert_array_equal(eng2.query(by[f"t{t}"]), _doracle(_keys(appended[t])))
    assert eng2.recovery_info["replay_anomalies"] == 0
    eng2.shutdown()


@pytest.mark.parametrize("write,read", [("mesh", "mesh"), ("local", "mesh"),
                                        ("mesh", "local")])
def test_crash_and_recover_across_meshes(tmp_path, write, read):
    """A durable engine (meshed or local) crashed after an unflushed tail,
    recovered onto the mesh or locally: backlogs, slot table and grants as
    an uninterrupted engine's, answers oracle-exact."""
    mesh = _five()
    eng = _engine(tmp_path / "crashed", mesh=mesh if write == "mesh" else None)
    sids, appended = _drive_pre_crash(eng)
    assert (eng._sec_assign >= 0).any()
    ref = _engine(tmp_path / "ref")
    _drive_pre_crash(ref)
    eng2 = recover(_dspec(), tmp_path / "crashed", mesh=mesh if read == "mesh" else None,
                   device="cpu")
    assert eng2.recovery_info["checkpoint_step"] is not None
    assert (eng2.mesh is not None) == (read == "mesh")
    whole = eng2._lanes.gather_states(eng2._states)
    _tree_eq(whole, ref._lanes.gather_states(ref._states))
    _check_recovered(eng2, sids, appended, ref)
    ref.shutdown()


def test_jax_local_directory_recovers_on_a_mesh(tmp_path):
    """A directory JAX's local durable engine wrote, abandoned mid-stream,
    recovers on a meshed port engine with JAX's uninterrupted answers."""
    jeng = _jax_engine(tmp_path / "jax")
    sids, appended = _drive_pre_crash(jeng)
    eng2 = SessionEngine.recover(_dspec(), tmp_path / "jax", mesh=_five(), device="cpu")
    assert eng2.recovery_info["checkpoint_step"] is not None
    assert len(eng2._states) == 5
    _check_recovered(eng2, sids, appended)
