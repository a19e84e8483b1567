"""Parity of the port's observability layer, error taxonomy and Eq. 2
admission with the JAX package, on the CPU.

The port keeps its own copies of the JAX package's pure-Python ``obs``
modules, ``serve/errors.py`` and ``scheduler.admission_score`` /
``plan_admission``: for the same operations they must give the same
output, the Prometheus exposition text byte for byte.  The port's
``core.compilemon`` counts nvcc builds and library loads where JAX counts
XLA compiles; these tests drive it with fake build events, so they need no
nvcc, once through ``kernels/_build.py`` itself with a stand-in compiler.
"""
import json
import stat
import sys
import urllib.request

import numpy as np
import pytest

from repro import obs as jobs_lib
from repro.core import scheduler as jscheduler
from repro.obs import metrics as jmetrics
from repro.obs import report as jreport
from repro.obs import skew as jskew
from repro.serve import errors as jerrors
from repro_torch import obs as obs_lib
from repro_torch.apps import histo
from repro_torch.core import compilemon, executor, scheduler
from repro_torch.kernels import _build
from repro_torch.obs import metrics, report, skew
from repro_torch.obs.scrape import PROM_CONTENT_TYPE, ScrapeServer
from repro_torch.serve import errors


def _script(reg):
    """One scripted sequence of registry operations: counters, gauges and
    histograms, with and without labels, label values that need escaping,
    default and custom buckets, and a re-registration."""
    c = reg.counter("requests_total", "requests served", labels=("tenant", "op"))
    c.inc(tenant="a", op="append")
    c.inc(2.5, tenant='b"q\\x\ny', op="query")
    c.inc(tenant="a", op="append")
    reg.counter("plain_total").inc(7)
    g = reg.gauge("queue_depth", "tuples queued", labels=("lane",))
    g.set(3, lane="0")
    g.add(-1.25, lane="0")
    g.set(1e-9, lane="1")
    reg.gauge("load_factor").set(0.5)
    h = reg.histogram("flush_latency_ms", "flush wall time", labels=("scope",))
    for v in (0.05, 1.0, 3.2, 250.0, 1e6):
        h.observe(v, scope="stream")
    h.observe(7, scope="engine")
    reg.histogram("tiny", "custom buckets", buckets=(0.5, 1.0, 2.0)).observe(1.0)
    reg.counter("requests_total", "requests served", labels=("tenant", "op")).inc(
        tenant="c", op="close")


def _registries():
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _script(reg)
    _script(jreg)
    return reg, jreg


def test_prometheus_text_byte_equal_to_jax():
    reg, jreg = _registries()
    text = reg.prometheus_text()
    assert text.encode() == jreg.prometheus_text().encode()
    assert "flush_latency_ms_bucket" in text and '\\"q\\\\x\\ny' in text


def test_parse_and_snapshot_equal_to_jax():
    reg, jreg = _registries()
    text = reg.prometheus_text()
    assert metrics.parse_prometheus(text) == jmetrics.parse_prometheus(text)
    assert metrics.snapshot_from_prometheus(text) == jmetrics.snapshot_from_prometheus(text)
    assert reg.snapshot() == jreg.snapshot()
    for bad in ("no_value_here", 'x{a="1} 2', "x 1 2 3"):
        with pytest.raises(ValueError):
            metrics.parse_prometheus(bad)
        with pytest.raises(ValueError):
            jmetrics.parse_prometheus(bad)


def test_disabled_registry_and_bundle():
    o = obs_lib.Observability(enabled=False)
    o.registry.counter("c").inc()
    with o.span("s"):
        pass
    assert o.registry.counter("c").value() == 0.0 and o.tracer.events() == []
    o.enabled = True
    assert o.registry.enabled and o.tracer.enabled
    shared = obs_lib.Observability()
    assert obs_lib.resolve(shared) is shared
    assert obs_lib.resolve(None).enabled and not obs_lib.resolve(False).enabled
    assert obs_lib.get_default() is obs_lib.get_default()


def test_tracer_export_schema(tmp_path):
    """Nested spans and an instant in the Chrome/Perfetto object format,
    with the same keys, names, phases and args as the JAX tracer's."""
    out = []
    for lib in (obs_lib, jobs_lib):
        o = lib.Observability()
        with o.span("stream.flush", cat="stream", pending=np.int64(3)):
            with o.span("stream.batch", cat="stream", size=2):
                o.tracer.instant("mark", cat="stream", k=1)
        path = tmp_path / f"{lib.__name__}.json"
        o.tracer.write(path)
        out.append(json.loads(path.read_text()))
    got, want = out
    assert set(got) == set(want) == {"traceEvents", "displayTimeUnit", "otherData"}

    def shape(doc):
        return [(e["name"], e["ph"], e.get("cat"), sorted(e), e.get("args"))
                for e in doc["traceEvents"]]
    assert shape(got) == shape(want)
    spans = {e["name"]: e for e in got["traceEvents"] if e["ph"] == "X"}
    flush, batch = spans["stream.flush"], spans["stream.batch"]
    assert flush["ts"] <= batch["ts"] and batch["ts"] + batch["dur"] <= flush["ts"] + flush["dur"]


def test_compilemon_counts_only_after_install(monkeypatch):
    monkeypatch.setattr(compilemon, "_installed", False)
    before = compilemon.snapshot()
    compilemon.record(1, 0.5)
    assert compilemon.since(before).n_compiles == 0
    compilemon.install()
    compilemon.install()                         # idempotent
    compilemon.record(2, 0.25)
    d = compilemon.since(before)
    assert d == compilemon.CompileDelta(n_compiles=2, stall_ms=250.0)


def test_compilemon_overlapping_windows_both_count():
    """The JAX package's interleaving contract: process-global counters,
    so two windows overlapping one build both count it."""
    compilemon.install()
    outer = compilemon.snapshot()
    inner = compilemon.snapshot()
    compilemon.record(1, 0.01)
    d_inner, d_outer = compilemon.since(inner), compilemon.since(outer)
    assert d_inner.n_compiles == d_outer.n_compiles == 1
    assert d_outer.n_compiles + d_inner.n_compiles > compilemon.since(outer).n_compiles


def test_region_exclusive_subtracts_children():
    with obs_lib.region("outer") as outer:
        compilemon.record(1, 0.002)
        with obs_lib.region("inner") as inner:
            compilemon.record(2, 0.003)
        with obs_lib.region("empty") as empty:
            pass
    assert inner.inclusive == inner.exclusive == compilemon.CompileDelta(2, 3.0)
    assert empty.inclusive.n_compiles == 0
    assert outer.inclusive.n_compiles == 3
    assert outer.exclusive.n_compiles == 1
    assert outer.exclusive.stall_ms == pytest.approx(
        outer.inclusive.stall_ms - inner.inclusive.stall_ms, abs=1e-2)


def test_build_reports_to_compilemon(tmp_path, monkeypatch):
    """kernels/_build.py reports each nvcc run to compilemon: a stand-in
    compiler that writes its -o file makes one build event."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'x')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    compilemon.install()
    with obs_lib.region("build") as r:
        logs = _build.build("route_accumulate", "cms_update")
        again = _build.build("route_accumulate")        # built: no event
    assert set(logs) == {"route_accumulate", "cms_update"} and again == {"route_accumulate": ""}
    assert r.inclusive.n_compiles == 2 and r.inclusive.stall_ms > 0


def test_executor_build_hook():
    """Every executor factory call counts in executor_builds_total{kind}
    on the default bundle, and leaves no executor.build span there (the
    build is a Python closure; compilemon counts the kernels' builds)."""
    o = obs_lib.get_default()
    fam = o.registry.counter("executor_builds_total", labels=("kind",))
    before = {k: fam.value(kind=k) for k in ("make_executor", "make_resumable_executor",
                                             "make_multistream_executor")}
    spec = histo.make_spec(64, 1 << 16, 4)
    executor.make_executor(spec, 4, 2, 64, device="cpu")
    executor.make_resumable_executor(spec, 4, 2, 64, device="cpu")
    executor.make_multistream_executor(spec, 4, 2, 64, device="cpu")
    for kind, n in before.items():
        assert fam.value(kind=kind) == n + 1, kind
    assert not [e for e in o.tracer.events() if e["name"] == "executor.build"]
    text = o.registry.prometheus_text()
    assert 'executor_builds_total{kind="make_multistream_executor"}' in text
    metrics.parse_prometheus(text)


def test_error_tables_equal_to_jax():
    assert errors.EXC_BY_STATUS.keys() == jerrors.EXC_BY_STATUS.keys()
    for status, cls in errors.EXC_BY_STATUS.items():
        jcls = jerrors.EXC_BY_STATUS[status]
        assert (cls.__name__, cls.status, cls.code) == (jcls.__name__, jcls.status, jcls.code)
        assert [b.__name__ for b in cls.__mro__] == [b.__name__ for b in jcls.__mro__]
        exc = errors.error_for_status(status, "m", retry_after_ms=12.5)
        jexc = jerrors.error_for_status(status, "m", retry_after_ms=12.5)
        assert type(exc).__name__ == type(jexc).__name__ and str(exc) == str(jexc)
        assert getattr(exc, "retry_after_ms", None) == getattr(jexc, "retry_after_ms", None)
        assert errors.status_of(exc) == jerrors.status_of(jexc) == status
    for status in (0, 11, 99, -1):
        assert type(errors.error_for_status(status, "m")).__name__ == \
            type(jerrors.error_for_status(status, "m")).__name__
    assert errors.status_of(KeyError()) == jerrors.status_of(KeyError()) == errors.ERR_INTERNAL
    names = [n for n in dir(jerrors) if n == "OK" or n.startswith("ERR_")]
    assert len(names) == 11
    assert {n: getattr(errors, n) for n in names} == {n: getattr(jerrors, n) for n in names}


def test_admission_equal_to_jax():
    rng = np.random.default_rng(7)
    for trial in range(20):
        t = int(rng.integers(1, 9))
        backlog = rng.integers(0, 50, t) * (trial % 3 != 0)
        occupancy = rng.integers(0, 4, t)
        np.testing.assert_array_equal(scheduler.admission_score(backlog, occupancy),
                                      jscheduler.admission_score(backlog, occupancy))
        pending = rng.integers(0, t, int(rng.integers(0, 12)))
        free = int(rng.integers(0, 8))
        got = scheduler.plan_admission(backlog, occupancy, free, pending)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(
            got, jscheduler.plan_admission(backlog, occupancy, free, pending))
    with pytest.raises(ValueError):
        scheduler.admission_score([1, 2], [1])
    with pytest.raises(ValueError):
        scheduler.plan_admission([1], [0], 1, [3])


class _FakeEngine:
    """What SkewMonitor reads of an engine: lane loads, tenant loads and
    the lifetime re-schedule count."""

    def __init__(self, rng):
        self.rng = rng
        self.slot_reschedules = 0

    def step(self):
        n = 6
        self.loads = self.rng.integers(0, 40, n).astype(np.float64)
        self.occupied = self.rng.random(n) < 0.7
        self.occ = {f"t{i}": int(self.rng.integers(1, 3)) for i in range(4)}
        self.bl = {f"t{i}": int(self.rng.integers(0, 500)) for i in range(3)}
        self.slot_reschedules += int(self.rng.integers(0, 3))

    def lane_loads(self):
        return self.loads, self.occupied

    def tenant_loads(self):
        return self.occ, self.bl


def test_skew_monitor_equal_to_jax():
    """The same series of engine observations and request latencies gives
    the same gauges, summary and exposition text as JAX's monitor."""
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    mon = skew.SkewMonitor(reg, slo_ms=20.0, window=16, min_interval_s=0.0)
    jmon = jskew.SkewMonitor(jreg, slo_ms=20.0, window=16, min_interval_s=0.0)
    eng, jeng = _FakeEngine(np.random.default_rng(3)), _FakeEngine(np.random.default_rng(3))
    rng = np.random.default_rng(4)
    for step in range(30):
        eng.step()
        jeng.step()
        assert mon.update_from_engine(eng) == jmon.update_from_engine(jeng)
        for _ in range(5):
            tenant = None if rng.random() < 0.1 else f"t{int(rng.integers(0, 40))}"
            ms = float(rng.exponential(15.0))
            mon.observe_request(tenant, ms)
            jmon.observe_request(tenant, ms)
    assert mon.summary() == jmon.summary()
    assert reg.prometheus_text() == jreg.prometheus_text()
    assert skew.imbalance_oracle([100, 300, 64], 64) == jskew.imbalance_oracle([100, 300, 64], 64)
    assert skew.MAX_TENANT_SERIES == jskew.MAX_TENANT_SERIES


def test_report_renders_as_jax():
    reg, jreg = _registries()
    mon = skew.SkewMonitor(reg, min_interval_s=0.0)
    jmon = jskew.SkewMonitor(jreg, min_interval_s=0.0)
    for m in (mon, jmon):
        m.observe_request("a", 250.0)
    snap = reg.snapshot()
    assert report.render(snap) == jreport.render(jreg.snapshot())
    assert report.render({"metrics": snap}) == jreport.render({"metrics": snap})


def test_scrape_server_answers_on_localhost():
    reg, _ = _registries()
    srv = ScrapeServer(reg, status_fn=lambda: {"lanes": 4},
                       health_fn=lambda: True)
    with srv:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            assert r.status == 200 and r.headers["Content-Type"] == PROM_CONTENT_TYPE
            body = r.read().decode()
        assert body == reg.prometheus_text()
        assert metrics.parse_prometheus(body) == metrics.parse_prometheus(reg.prometheus_text())
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
            assert r.status == 200
        with urllib.request.urlopen(srv.url + "/statusz", timeout=10) as r:
            assert json.loads(r.read()) == {"lanes": 4}
        snap = report.fetch_url(srv.url, timeout=10)
        assert snap["status"] == {"lanes": 4}
        assert snap["metrics"] == metrics.snapshot_from_prometheus(body)
    assert srv._thread is None or not srv._thread.is_alive()
