"""Parity of the port's PageRank, DP, replicated baseline and router with
the JAX package, on the CPU.

The same seeded numpy input goes through both packages: PageRank's merged
sums (X = 0, 2 and M-1, a masked ragged tail), its edge contributions and
15 damped iterations; DP's output regions, cursors and partition tags
below capacity (masked rows included) and the partitions read out of them,
also from a mid-stream state carried across; the replicated baseline's
aggregate and float32 cycles; ``decode_filter`` / ``route_dense``; and the
rows of the Fig. 8 benchmark.  Everything here is integer, or float32
computed in the same order, and must match bit for bit.  Small sizes:
M = 8 (a 32-byte memory word), chunks of 256 tuples, except Fig. 8's rows
(M = 16, chunks of 4096, V = 2^12, as the benchmark runs them).
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import dp as jdp
from repro.apps import hhd as jhhd
from repro.apps import histo as jhisto
from repro.apps import hll as jhll
from repro.apps import pagerank as jpagerank
from repro.core import baseline as jbaseline
from repro.core import executor as jexecutor
from repro.core import router as jrouter
from repro.core.framework import Ditto as JDitto
from repro_torch import interop
from repro_torch.apps import dp, hhd, histo, hll, pagerank
from repro_torch.core import Ditto, baseline, executor, router
from repro_torch.data import graphs
from repro_torch.data.zipf import zipf_tuples

CHUNK = 256
MEM_WIDTH = 32          # Eq. 1: 32 B / 8 B tuples x II_pe 2 -> M = 8
M = 8
V = 256


def _pair(spec, jspec, **kw):
    d = Ditto(spec, chunk_size=CHUNK, mem_width_bytes=MEM_WIDTH, device="cpu", **kw)
    jd = JDitto(jspec, chunk_size=CHUNK, mem_width_bytes=MEM_WIDTH, **kw)
    assert d.num_pri == jd.num_pri == M
    return d, jd


def _stats_eq(stats, jstats):
    for f in dataclasses.fields(stats):
        got, want = getattr(stats, f.name).numpy(), np.asarray(getattr(jstats, f.name))
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def _graph(kind="rmat", v=V, seed=5):
    if kind == "rmat":
        return graphs.rmat_graph(v, 8 * v, seed=seed)
    return graphs.uniform_graph(v, 16 * v, seed=seed)


@pytest.mark.parametrize("num_sec", [0, 2, M - 1])
def test_pagerank_merged_sums_bit_exact(num_sec):
    """One scatter phase of an R-MAT graph with a ragged tail: the same
    merged sums and stats as JAX, equal to the oracle."""
    edges = _graph()[:4000]                       # 15 chunks + a tail of 160
    deg = graphs.out_degrees(edges, V)
    rank = pagerank.init_rank(V) + np.arange(V, dtype=np.int32) * 97
    d, jd = _pair(pagerank.make_spec(V, M), jpagerank.make_spec(V, M))
    contrib = pagerank.edge_contributions(torch.from_numpy(edges), torch.from_numpy(rank),
                                          torch.from_numpy(deg)).numpy()
    chunks, mask = d.chunk_masked(contrib)
    merged, stats = d.generate([num_sec])[0].run(chunks, mask=mask)
    jchunks, jmask = jd.chunk_masked(contrib)
    jmerged, jstats = jd.generate([num_sec])[0].run(jchunks, mask=jmask)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    _stats_eq(stats, jstats)
    np.testing.assert_array_equal(merged.numpy(),
                                  pagerank.oracle_scatter(edges, rank, deg, V, M))


@pytest.mark.parametrize("app", ["pagerank", "histo", "hll", "hhd"])
def test_prepe_hands_the_kernels_contiguous_int32(app):
    """On the card the PE-update kernels take idx and value as they come,
    int32 and contiguous, or raise: every PrePE whose tuples reach them
    (PageRank's value is a column of the chunk) hands over just that."""
    spec = {"pagerank": pagerank.make_spec(V, M), "histo": histo.make_spec(64, 1 << 16, M),
            "hll": hll.make_spec(8, M), "hhd": hhd.make_spec(4, 128, M)}[app]
    chunk = torch.from_numpy(zipf_tuples(CHUNK, 1 << 16, 1.0, seed=1) % V)
    for t in spec.pre(chunk, M):
        assert t.dtype == torch.int32 and t.is_contiguous()


def test_pagerank_golden_digest(zipf_dataset):
    """The JAX package's golden PageRank run (tests/test_golden_apps.py),
    through the port: the same bytes."""
    data = zipf_dataset(2048, 1 << 16, 1.5).copy()
    data[:, 0] %= 256
    data[:, 1] %= 1 << 16
    run = executor.make_executor(pagerank.make_spec(256, M), M, 2, CHUNK, device="cpu")
    merged = run(torch.from_numpy(data.reshape(-1, CHUNK, 2)))[0].numpy()
    assert hashlib.sha256(np.ascontiguousarray(merged).tobytes()).hexdigest()[:16] \
        == "d4979deeee634fc9"


@pytest.mark.parametrize("kind", ["rmat", "uniform"])
def test_edge_contributions_equal(kind):
    edges = _graph(kind)
    deg = graphs.out_degrees(edges, V)
    deg[::7] = 0                                  # clamped to 1 in both
    rank = np.random.default_rng(1).integers(0, 1 << 20, V).astype(np.int32)
    got = pagerank.edge_contributions(torch.from_numpy(edges), torch.from_numpy(rank),
                                      torch.from_numpy(deg))
    want = np.asarray(jpagerank.edge_contributions(edges, rank, deg))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_pagerank_graphs_equal_jax():
    from repro.data import graphs as jgraphs
    np.testing.assert_array_equal(graphs.rmat_graph(V, 999, seed=3, undirected=False),
                                  jgraphs.rmat_graph(V, 999, seed=3, undirected=False))
    np.testing.assert_array_equal(graphs.uniform_graph(V, 999, seed=3),
                                  jgraphs.uniform_graph(V, 999, seed=3))
    e = graphs.rmat_graph(V, 999, seed=3)
    np.testing.assert_array_equal(graphs.graph_to_edge_tuples(e), jgraphs.graph_to_edge_tuples(e))


def test_pagerank_iterations_equal_jax():
    """15 damped iterations, each a full pass of both executors: the same
    ranks after every one, within 1e-3 of the float reference at the end."""
    edges = _graph()                              # 4096 edges: 16 chunks
    deg = graphs.out_degrees(edges, V)
    d, jd = _pair(pagerank.make_spec(V, M), jpagerank.make_spec(V, M))
    x = d.select(edges[:, 1])
    assert x == jd.select(edges[:, 1]) > 0
    run, jrun = d.generate([x])[0].run, jd.generate([x])[0].run
    rank = jrank = pagerank.init_rank(V)
    for _ in range(15):
        contrib = pagerank.edge_contributions(torch.from_numpy(edges), torch.from_numpy(rank),
                                              torch.from_numpy(deg))
        sums, _ = run(d.chunk(contrib.numpy()))
        jsums, _ = jrun(jd.chunk(np.asarray(
            jpagerank.edge_contributions(edges, jrank, deg))))
        rank = pagerank.apply_damping(sums.numpy(), V)
        jrank = jpagerank.apply_damping(np.asarray(jsums), V)
        np.testing.assert_array_equal(rank, jrank)
    got = rank.astype(np.float64) / pagerank.ONE / V
    assert np.abs(got - pagerank.pagerank_reference(edges, V, iters=15)).max() < 1e-3


def test_pagerank_numpy_helpers_equal_jax():
    edges = _graph()
    deg = graphs.out_degrees(edges, V)
    rank = pagerank.init_rank(V)
    np.testing.assert_array_equal(rank, jpagerank.init_rank(V))
    sums = pagerank.oracle_scatter(edges, rank, deg, V, M)
    np.testing.assert_array_equal(sums, jpagerank.oracle_scatter(edges, rank, deg, V, M))
    np.testing.assert_array_equal(pagerank.apply_damping(sums, V),
                                  jpagerank.apply_damping(sums, V))
    np.testing.assert_array_equal(pagerank.pagerank_reference(edges, V, 3),
                                  jpagerank.pagerank_reference(edges, V, 3))
    with pytest.raises(AssertionError):
        pagerank.make_spec(pagerank.MAX_VERTICES + 1, 16)


def _dp_pair(num_sec, capacity):
    d, jd = _pair(dp.make_spec(4, M, capacity), jdp.make_spec(4, M, capacity))
    return d, jd, d.generate([num_sec])[0], jd.generate([num_sec])[0]


def _dp_eq(bufs, jbufs):
    for name in ("out", "cursor", "dst_part"):
        got, want = getattr(bufs, name).numpy(), np.asarray(getattr(jbufs, name))
        assert got.dtype == want.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("num_sec", [0, 3])
def test_dp_buffers_and_partitions_equal_jax(num_sec):
    """A skewed stream with a masked ragged tail, below capacity: the same
    regions (slot order too), cursors and tags as JAX, and the same
    partitions in the same order; as multisets they equal the oracle."""
    tuples = zipf_tuples(CHUNK * 10 + 99, 1 << 16, 1.5, seed=11)
    d, jd, impl, jimpl = _dp_pair(num_sec, capacity=2048)
    chunks, mask = d.chunk_masked(tuples)
    bufs, stats = impl.run(chunks, mask=mask)
    jchunks, jmask = jd.chunk_masked(tuples)
    jbufs, jstats = jimpl.run(jchunks, mask=jmask)
    assert int(bufs.cursor.max()) < 2048
    _dp_eq(bufs, jbufs)
    _stats_eq(stats, jstats)
    parts = dp.partitions_from_buffers(bufs, 16)
    jparts = jdp.partitions_from_buffers(jbufs, 16)
    want = dp.oracle(tuples, 4)
    assert len(parts) == len(jparts) == len(want) == 16
    for p, jp, w, jw in zip(parts, jparts, want, jdp.oracle(tuples, 4)):
        assert p.dtype == jp.dtype
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(w, jw)
        assert dp.multiset_equal(p, w) and jdp.multiset_equal(p, w)


def test_dp_masked_chunk_filling_a_region_to_capacity():
    """A chunk with masked rows fills PE 1's region to exactly its
    capacity: the last kept tuple is written, as in JAX, and the regions
    are equal slot for slot."""
    keys = np.array([[1, 1, 1, 0], [1, 0, 0, 0]], np.int32)
    tuples = np.stack([keys, np.arange(100, 108, dtype=np.int32).reshape(2, 4)], -1)
    mask = np.array([[True] * 4, [True, False, False, False]])
    run = executor.make_executor(dp.make_spec(1, 2, 4), 2, 0, 4, device="cpu")
    jrun = jexecutor.make_executor(jdp.make_spec(1, 2, 4), 2, 0, 4)
    bufs, _ = run(torch.as_tensor(tuples), mask=torch.as_tensor(mask))
    jbufs, _ = jrun(jnp.asarray(tuples), mask=jnp.asarray(mask))
    _dp_eq(bufs, jbufs)
    parts = dp.partitions_from_buffers(bufs, 2)
    assert [p[:, 1].tolist() for p in parts] == [[103], [100, 101, 102, 104]]
    assert [p[:, 1].tolist() for p in jdp.partitions_from_buffers(jbufs, 2)] == \
        [[103], [100, 101, 102, 104]]


def test_dp_mid_stream_state_carried_across():
    """A JAX DP state after 5 chunks, moved into the port with interop,
    continues exactly as the JAX executor continues it."""
    tuples = zipf_tuples(CHUNK * 12, 1 << 16, 2.0, seed=12)
    d, jd, _, _ = _dp_pair(0, capacity=4096)
    jres = jexecutor.make_resumable_executor(jd.spec, M, 5, CHUNK,
                                             mem_width_tuples=jd.mem_width_tuples)
    res = executor.make_resumable_executor(d.spec, M, 5, CHUNK,
                                           mem_width_tuples=d.mem_width_tuples, device="cpu")
    mid, _ = jres.run_chunks(jres.init_state(), jd.chunk(tuples)[:5])
    jend, jstats = jres.run_chunks(mid, jd.chunk(tuples)[5:])
    arrays = jax.tree.map(np.asarray, dataclasses.asdict(mid))
    arrays["buffers"] = arrays["buffers"]._asdict()
    state = interop.state_from_numpy(arrays, device="cpu")
    end, stats = res.run_chunks(state, d.chunk(tuples)[5:])
    _stats_eq(stats, jstats)
    _dp_eq(res.merge_state(end), jres.merge_state(jend))
    assert set(interop.state_to_numpy(end)["buffers"]) == {"out", "cursor", "dst_part"}
    np.testing.assert_array_equal(
        interop.state_to_numpy(end)["buffers"]["out"], np.asarray(jend.buffers.out))


def test_dp_multiset_equal_agrees_with_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(-2**31, 2**31, (500, 2), dtype=np.int64).astype(np.int32)
    a[:50] = a[50:100]                            # repeated rows
    cases = [(a, a[::-1].copy()), (a, a[rng.permutation(500)]),
             (a, np.concatenate([a[:-1], a[:1]])), (a, a[:, ::-1].copy()), (a, a[:499]),
             (a[:0], a[:0])]
    for x, y in cases:
        assert dp.multiset_equal(x, y) == jdp.multiset_equal(x, y)
    assert [dp.multiset_equal(x, y) for x, y in cases] == [True, True, False, False, False, True]


def test_dp_threshold_raises():
    spec = dp.make_spec(4, M, 64)
    with pytest.raises(ValueError, match="non-decomposable"):
        executor.make_resumable_executor(spec, M, 2, CHUNK, threshold=0.5, device="cpu")
    with pytest.raises(ValueError, match="non-decomposable"):
        executor.make_executor(spec, M, 2, CHUNK, threshold=0.5, device="cpu")


BASELINE_APPS = {
    "histo": (lambda m: histo.make_spec(512, 1 << 20, m),
              lambda m: jhisto.make_spec(512, 1 << 20, m),
              lambda k: histo.oracle(k, 512, 1 << 20, 1)),
    "hll": (lambda m: hll.make_spec(12, m), lambda m: jhll.make_spec(12, m),
            lambda k: hll.oracle(k, 12, 1)),
    "hhd": (lambda m: hhd.make_spec(4, 1024, m), lambda m: jhhd.make_spec(4, 1024, m),
            lambda k: hhd.oracle(k, 4, 1024, 1)),
}


@pytest.mark.parametrize("app", list(BASELINE_APPS))
def test_replicated_baseline_equal_jax(app):
    """Static dispatch over 16 replicas: the same aggregate (the app's flat
    oracle), the same float32 chunk and merge cycles, the same buffer
    bytes; and Table II's per-app buffer saving."""
    mk, jmk, oracle = BASELINE_APPS[app]
    tuples = zipf_tuples(4096 * 3, 1 << 20, 2.0, seed=5)
    chunks = tuples.reshape(3, 4096, 2)
    agg, st = baseline.make_replicated_executor(mk(1), 16, 4096, device="cpu")(chunks)
    jagg, jst = jbaseline.make_replicated_executor(jmk(1), 16, 4096)(jnp.asarray(chunks))
    assert agg.dtype == torch.int32
    np.testing.assert_array_equal(agg.numpy(), np.asarray(jagg))
    np.testing.assert_array_equal(agg.numpy(), oracle(tuples[:, 0]))
    for key in ("chunk_cycles", "merge_cycles"):
        got, want = st[key].numpy(), np.asarray(jst[key])
        assert got.dtype == want.dtype == np.float32, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert baseline.replica_buffer_bytes(mk(1), 16) == jbaseline.replica_buffer_bytes(jmk(1), 16)
    for x in (0, 5):
        assert (baseline.routed_buffer_bytes(mk(16), 16, x)
                == jbaseline.routed_buffer_bytes(jmk(16), 16, x))
    saving = baseline.replica_buffer_bytes(mk(1), 16) / baseline.routed_buffer_bytes(mk(16), 16, 0)
    assert saving == (1.0 if app == "hhd" else 16.0)
    if app == "histo":          # Table II: routing gives the same final bins
        routed, _ = executor.make_executor(mk(16), 16, 0, 4096, device="cpu")(chunks)
        np.testing.assert_array_equal(histo.flat_histogram(routed.numpy(), 512), agg[0].numpy())


def test_flat_histogram_equal_jax():
    merged = histo.oracle(zipf_tuples(5000, 1 << 16, 1.0, seed=2)[:, 0], 100, 1 << 16, M)
    np.testing.assert_array_equal(histo.flat_histogram(merged, 100),
                                  jhisto.flat_histogram(merged, 100))


@pytest.mark.parametrize("capacity", [1, 40, 300])
def test_decode_filter_and_route_dense_equal_jax(capacity):
    """Per-PE positions (padded with -1, cut at capacity) and counts, for
    one datapath and for all, with PE ids outside [0, P) in the stream."""
    dst = np.random.default_rng(capacity).integers(-1, 12, 300).astype(np.int32)
    dst[:50] = 3                                  # one hot PE
    pos, cnt = router.route_dense(torch.from_numpy(dst), 11, capacity)
    jpos, jcnt = jrouter.route_dense(jnp.asarray(dst), 11, capacity)
    assert pos.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    for pe in (0, 3, 10):
        p, c = router.decode_filter(torch.from_numpy(dst), pe, capacity)
        jp, jc = jrouter.decode_filter(jnp.asarray(dst), pe, capacity)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        assert int(c) == int(jc)


FIG8_GRAPHS = {
    "uniform-8": lambda v: graphs.uniform_graph(v, v * 8, seed=1),
    "rmat-8": lambda v: graphs.rmat_graph(v, v * 8, seed=1),
    "rmat-16": lambda v: graphs.rmat_graph(v, v * 16, seed=2),
    "rmat-32": lambda v: graphs.rmat_graph(v, v * 32, seed=3),
}


@pytest.mark.parametrize("graph", list(FIG8_GRAPHS))
def test_fig8_rows_equal_jax(graph):
    """benchmarks/fig8_pagerank.py's row of each graph at V = 2^12: the X
    pick, and the modeled cycles of X = 0 and of Ditto's X (so the
    speedup), from both packages' executors."""
    v, chunk = 1 << 12, 4096
    edges = FIG8_GRAPHS[graph](v)
    rank, deg = pagerank.init_rank(v), graphs.out_degrees(edges, v)
    contrib = pagerank.edge_contributions(torch.from_numpy(edges), torch.from_numpy(rank),
                                          torch.from_numpy(deg)).numpy()
    tuples = contrib[:len(contrib) // chunk * chunk].reshape(-1, chunk, 2)
    d = Ditto(pagerank.make_spec(v, 16), chunk_size=chunk, device="cpu")
    jd = JDitto(jpagerank.make_spec(v, 16), chunk_size=chunk)
    x = d.select(edges[:, 1], tolerance=0.01)
    assert x == jd.select(edges[:, 1], tolerance=0.01)
    cycles = []
    for num_sec in (0, x):
        merged, stats = d.generate([num_sec])[0].run(torch.from_numpy(tuples))
        jmerged, jstats = jd.generate([num_sec])[0].run(tuples)
        np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
        np.testing.assert_array_equal(stats.modeled_cycles.numpy(),
                                      np.asarray(jstats.modeled_cycles))
        cycles.append(float(stats.modeled_cycles.double().sum()))
    speedup = cycles[0] / cycles[1]
    assert (x == 0) == (speedup == 1.0)
    if graph == "rmat-32":
        assert speedup > 1.5                      # the benchmark's own check
