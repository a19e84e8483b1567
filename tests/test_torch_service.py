"""Parity of the port's ``SessionService`` with the JAX package's, on the CPU.

The front door is held against ``repro.serve.service`` at three levels:

* the codec, byte for byte: ``encode_frame`` of the same (meta, payload)
  gives the same bytes in both packages, each ``FrameDecoder`` decodes the
  other's frames at every split, and every malformed frame raises
  ``ProtocolError`` with the same message in both;
* live, across the packages: JAX's client drives the port's service and the
  port's client drives JAX's, with oracle-exact answers and the same error
  classes and RETRY-AFTER hints;
* a wire ``WireTwin``: one seeded request stream through JAX's engine
  behind JAX's service and the port's engine behind the port's, with equal
  response metas (trace ids left out) and payload bytes, equal ``stats``
  (wall-clock and build counters left out) and equal ``service_*`` counter
  series after every request, in ``fifo`` and ``scored`` admission.

Then the ingress policy of ``tests/test_service.py`` (token bucket, rate
limit, backpressure, scored admission, live protocol fuzz, the taxonomy
over the wire), the scrape sidecar and wire tracing of
``tests/test_scrape.py`` and ``tests/test_wire_trace.py``, the port's storm
machine over the wire (``tests/test_torch_session.py``'s ``OracleHarness``
in network mode: a durable engine, two alternating clients, forced
disconnects mid-append, recovery across a service restart), two concurrent
clients, and ``status()`` touching no tensor.

Every engine here runs on the CPU (the port's with ``device="cpu"``, JAX's
with its default kernel backend, the ``jnp`` path); services bind port 0 on
127.0.0.1; clients wait up to 60 s; conditions are polled, never slept on.
A JAX service's ``stop()`` waits for its client connections to drop, so
every client of one is closed before its service stops.
"""
from __future__ import annotations

import contextlib
import json
import struct
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from repro.apps import histo as jhisto
from repro.serve import SessionEngine as JSessionEngine
from repro.serve import service as jsvc
from repro_torch import obs as obs_lib
from repro_torch.apps import histo
from repro_torch.obs import report
from repro_torch.obs.metrics import parse_prometheus
from repro_torch.obs.trace import new_trace_context
from repro_torch.serve import SessionEngine
from repro_torch.serve import errors as err
from repro_torch.serve import service as psvc

from test_torch_session import (BINS, CHUNK, DOMAIN, HAVE_HYPOTHESIS, M, PRIMARY,
                                SECONDARY, X, OracleHarness, OracleModel, _data, _oracle)

PKGS = {"jax": jsvc, "port": psvc}
_FRAME = struct.Struct("<II")
CLIENT_TIMEOUT = 60.0


# ---------------------------------------------------------------------------
# Shared plumbing
# ---------------------------------------------------------------------------

class FakeClock:
    """A monotonic clock the test moves by hand (rate-limit tests)."""

    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


def _port_engine(primary: int = PRIMARY, aot=None, **kw):
    return SessionEngine(histo.make_spec(BINS, DOMAIN, M), num_pri=M, num_sec=X,
                         chunk_size=CHUNK, primary_slots=primary, secondary_slots=SECONDARY,
                         aot_buckets=aot, device="cpu", **kw)


def _jax_engine(primary: int = PRIMARY):
    return JSessionEngine(jhisto.make_spec(BINS, DOMAIN, M), num_pri=M, num_sec=X,
                          chunk_size=CHUNK, primary_slots=primary, secondary_slots=SECONDARY)


@contextlib.contextmanager
def _serving(pkg, engine, cfg=None, **kw):
    svc = pkg.SessionService(engine, cfg or pkg.ServiceConfig(admission="fifo"), **kw)
    svc.start()
    try:
        yield svc
    finally:
        svc.stop()


@contextlib.contextmanager
def _service(primary_slots: int = 4, cfg=None, clock=time.monotonic, **engine_kw):
    """The port's engine (CPU) behind the port's service."""
    with _serving(psvc, _port_engine(primary_slots, **engine_kw), cfg, clock=clock) as svc:
        yield svc


def _client(svc, pkg=psvc, **kw):
    return pkg.ServiceClient(*svc.address, timeout=CLIENT_TIMEOUT, **kw)


def _wait_for(pred, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.002)
    return False


def _fingerprint(eng) -> dict:
    """The engine's sid/slot bookkeeping -- what a malformed frame must
    never perturb."""
    return {"next_sid": eng._next_sid, "slot_sid": list(eng._slot_sid),
            "free": sorted(eng._free_slots), "queue": list(eng._queue),
            "sessions": {sid: (s.tenant, s.closed, s.slot, s.backlog_tuples)
                         for sid, s in eng.sessions.items()}}


def _held(svc) -> int:
    return svc.status()["service"]["held_opens"]


def _get(url: str, timeout: float = 30.0):
    """(status, content_type, body text); HTTP errors become statuses."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode("utf-8")


# ---------------------------------------------------------------------------
# The codec, byte for byte
# ---------------------------------------------------------------------------

def _seeded_frames(seed: int, n: int = 24):
    """(meta, payload) pairs: nested JSON headers with unicode tenants and
    arrays of int32/float32 in 0-3 dims, empty ones included."""
    rng = np.random.default_rng(seed)
    tenants = ["t0", "tenant-ü", "租户", "emoji-🙂", "", "a\"b\\c\n"]
    out = []
    for i in range(n):
        ndim = int(rng.integers(0, 4))
        shape = tuple(int(rng.integers(0, 4)) for _ in range(ndim))
        dtype = (np.int32, np.float32)[int(rng.integers(2))]
        a = (rng.standard_normal(shape) * 100).astype(dtype)
        meta = {"op": ("append", "query", "open", "stats")[i % 4], "id": i,
                "tenant": tenants[int(rng.integers(len(tenants)))],
                "sid": int(rng.integers(0, 1 << 20)),
                "array": psvc._arr_meta(a),
                "nested": {"x": [1, 2.5, None, True, {"y": "z"}], "b": -3},
                "trace": new_trace_context()}
        out.append((meta, a, a.tobytes()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_frame_bytes_equal(seed):
    for meta, a, payload in _seeded_frames(seed):
        assert psvc._arr_meta(a) == jsvc._arr_meta(a)
        frame = psvc.encode_frame(meta, payload)
        assert frame == jsvc.encode_frame(meta, payload)
        for pkg in PKGS.values():
            dec = pkg.FrameDecoder()
            dec.feed(frame)
            got_meta, got_payload = dec.next()
            assert got_meta == meta and got_payload == payload
            back = pkg._arr_from(got_meta["array"], got_payload)
            assert back.dtype == a.dtype and back.shape == a.shape
            np.testing.assert_array_equal(back, a)
    assert psvc.MAGIC == jsvc.MAGIC and psvc.OPS == jsvc.OPS
    assert psvc.DEFAULT_MAX_FRAME == jsvc.DEFAULT_MAX_FRAME


@pytest.mark.parametrize("enc,dec", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_decoder_takes_the_other_packages_frames_at_every_split(enc, dec):
    a = _data(3, 5)
    frames = (PKGS[enc].encode_frame({"op": "append", "sid": 3, "id": 1,
                                      "array": psvc._arr_meta(a)}, a.tobytes())
              + PKGS[enc].encode_frame({"op": "ping", "id": 2, "tenant": "ü"}))
    for cut in range(len(frames) + 1):
        d = PKGS[dec].FrameDecoder()
        got = []
        for piece in (frames[:cut], frames[cut:]):
            d.feed(piece)
            while (msg := d.next()) is not None:
                got.append(msg)
        assert [m for m, _ in got] == [
            {"op": "append", "sid": 3, "id": 1, "array": psvc._arr_meta(a)},
            {"op": "ping", "id": 2, "tenant": "ü"}]
        np.testing.assert_array_equal(PKGS[dec]._arr_from(got[0][0]["array"], got[0][1]), a)
        assert d.buffered == 0


def _framed_body(head: bytes) -> bytes:
    body = struct.pack("<I", len(head)) + head
    return _FRAME.pack(len(body), zlib.crc32(body)) + body


def _crc_flipped() -> bytes:
    frame = bytearray(psvc.encode_frame({"op": "ping"}))
    frame[-1] ^= 0x40
    return bytes(frame)


MALFORMED = {
    "oversize": (1024, _FRAME.pack(1025, 0)),
    "undersize": (None, _FRAME.pack(2, 0) + b"xx"),
    "crc": (None, _crc_flipped()),
    "header_overrun": (None, (lambda b: _FRAME.pack(len(b), zlib.crc32(b)) + b)(
        struct.pack("<I", 999) + b"{}")),
    "undecodable": (None, _framed_body(b"\xff\xfe not json")),
    "non_object": (None, _framed_body(b"[1,2,3]")),
}


def _protocol_error(fn) -> str:
    with pytest.raises(Exception) as ei:
        fn()
    assert type(ei.value).__name__ == "ProtocolError"
    return str(ei.value)


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_frame_same_message(case):
    cap, raw = MALFORMED[case]
    msgs = {}
    for name, pkg in PKGS.items():
        d = pkg.FrameDecoder() if cap is None else pkg.FrameDecoder(max_frame=cap)
        d.feed(raw)
        first = _protocol_error(d.next)
        # the decoder is poisoned after the first error, in both
        msgs[name] = (first, _protocol_error(lambda: d.feed(b"x")), _protocol_error(d.next))
    assert msgs["port"] == msgs["jax"]
    assert msgs["port"][1] == "decoder poisoned by an earlier bad frame"


def test_payload_size_mismatch_same_message():
    for meta, payload in (({"dtype": "<i4", "shape": [4, 2]}, b"\x00" * 7),
                          ({"dtype": "<i4"}, b""), ({"dtype": "nope", "shape": [1]}, b"")):
        assert _protocol_error(lambda: psvc._arr_from(meta, payload)) == \
            _protocol_error(lambda: jsvc._arr_from(meta, payload))


def test_fuzz_bitflips_and_truncations_never_decode():
    """A flipped bit never decodes (both packages reject it with the same
    message, or wait for more bytes); a truncated frame waits, and its rest
    restores it."""
    a = _data(1, 24)
    base = psvc.encode_frame({"op": "append", "sid": 0, "id": 1,
                              "array": psvc._arr_meta(a)}, a.tobytes())
    rng = np.random.default_rng(7)
    for _ in range(300):
        mutated = bytearray(base)
        pos = int(rng.integers(len(mutated)))
        mutated[pos] ^= 1 << int(rng.integers(8))
        outs = []
        for pkg in PKGS.values():
            d = pkg.FrameDecoder()
            d.feed(bytes(mutated))
            try:
                outs.append(("none", d.next()))
            except Exception as e:
                outs.append((type(e).__name__, str(e)))
        assert outs[0] == outs[1], (pos, outs)
        assert outs[0][0] == "ProtocolError" or outs[0][1] is None, (pos, outs)
    for _ in range(100):
        cut = int(rng.integers(1, len(base)))
        for pkg in PKGS.values():
            d = pkg.FrameDecoder()
            d.feed(base[:cut])
            assert d.next() is None and d.buffered == cut
            d.feed(base[cut:])
            assert d.next()[0]["op"] == "append"


# ---------------------------------------------------------------------------
# Across the packages, live
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_client_drives_the_other_packages_service(client, server):
    """A full lifecycle through the other package's service, bit-exact
    against the oracle; the same error classes and RETRY-AFTER arrive."""
    cpkg, spkg = PKGS[client], PKGS[server]
    eng = _port_engine(primary=3) if server == "port" else _jax_engine(primary=3)
    clk = FakeClock()
    cfg = spkg.ServiceConfig(admission="fifo", rate_limit=10.0, rate_burst=2.0)
    with _serving(spkg, eng, cfg, clock=clk) as svc:
        with _client(svc, cpkg) as c:
            def tick():
                clk.t += 1.0          # refills every bucket to its burst
            assert c.ping()
            d1, d2 = _data(1, 3 * CHUNK + 5), _data(2, 17)
            sid = c.open("tenant-a")
            tick()
            assert c.append(sid, d1) == len(d1)
            tick()
            assert c.append(sid, d2) == len(d2)
            tick()
            assert c.append(sid, _data(0, 0)) == 0
            want = _oracle([d1[:, 0], d2[:, 0]])
            tick()
            np.testing.assert_array_equal(c.query(sid), want)
            tick()
            np.testing.assert_array_equal(c.query(sid, scope="engine"), want)
            tick()
            firsts = [_data(10, CHUNK + 3), None]
            sids = c.open_batch(["b", "c"], first=firsts)
            assert sids == [sid + 1, sid + 2]
            tick()
            np.testing.assert_array_equal(c.query(sids[0]), _oracle([firsts[0][:, 0]]))
            tick()
            merged, stats = c.close(sid)
            np.testing.assert_array_equal(merged, want)
            assert stats["tuples_appended"] == len(d1) + len(d2)
            tick()
            cases = [("UnknownSessionError", lambda: c.query(10_000)),
                     ("ClosedSessionError", lambda: c.append(sid, _data(3, 4))),
                     ("ShapeMismatchError", lambda: c.append(sids[0], np.zeros((4, 3), np.int32)))]
            for name, call in cases:
                tick()
                with pytest.raises(cpkg.err.SessionError) as ei:
                    call()
                assert type(ei.value).__name__ == name
            # rate limit: tenant r's two tokens, then RETRY-AFTER of 100 ms
            tick()
            sid_r = c.open("r")
            c.append(sid_r, _data(4, 8))
            with pytest.raises(cpkg.err.RateLimitedError) as ei:
                c.append(sid_r, _data(5, 8))
            assert ei.value.retry_after_ms == pytest.approx(100.0)
            clk.t += 0.1
            c.append(sid_r, _data(6, 8))
            assert c.stats()["open_sessions"] == 3


class WireTwin:
    """One request stream, two services: JAX's engine behind JAX's service
    and the port's engine behind the port's.  Each request goes out as the
    same raw frame on each side; after it, the response metas (trace left
    out, its echo checked) and payload bytes, the ``stats`` (wall-clock and
    build counters left out) and the ``service_*`` counter series are
    equal."""

    TIMED = ("compile_stall_ms", "admit_stall_ms", "n_retraces", "n_retraces_admit")

    def __init__(self, admission: str):
        self.sides = []
        for pkg, eng in ((jsvc, _jax_engine()), (psvc, _port_engine())):
            svc = pkg.SessionService(eng, pkg.ServiceConfig(admission=admission))
            svc.start()
            self.sides.append({"pkg": pkg, "svc": svc, "conn": _client(svc, pkg, trace=False)})
        self.seq = 0
        self.n_checked = 0

    def close(self):
        for s in self.sides:
            for c in (s["conn"], s.pop("conn2", None)):
                if c is not None:
                    c.close_conn()
        for s in self.sides:
            s["svc"].stop()

    def _frame(self, meta, payload=b""):
        self.seq += 1
        meta = dict(meta, id=self.seq, trace=new_trace_context())
        frame = psvc.encode_frame(meta, payload)
        assert frame == jsvc.encode_frame(meta, payload)
        return meta, frame

    def _pair(self, resps, meta):
        (jm, jp), (pm, pp) = resps
        for m in (jm, pm):
            assert m.pop("trace")["trace_id"] == meta["trace"]["trace_id"]
        assert pm == jm and pp == jp, (meta["op"], jm, pm)
        return pm, pp

    def send(self, meta, payload=b"", check=True):
        meta, frame = self._frame(meta, payload)
        for s in self.sides:
            s["conn"].send_raw(frame)
        out = self._pair([s["conn"].read_response() for s in self.sides], meta)
        if check:
            self.check()
        return out

    def park_open(self, tenant: str):
        """An open sent on a second connection that parks (scored mode)."""
        meta, frame = self._frame({"op": "open", "tenant": tenant})
        for s in self.sides:
            s["conn2"] = _client(s["svc"], s["pkg"], trace=False)
            s["conn2"].send_raw(frame)
        assert _wait_for(lambda: all(_held(s["svc"]) == 1 for s in self.sides))
        return meta

    def read_parked(self, meta):
        out = self._pair([s["conn2"].read_response() for s in self.sides], meta)
        for s in self.sides:
            s.pop("conn2").close_conn()
        return out

    def check(self):
        (jm, _), (pm, _) = [s["conn"].request({"op": "stats"}) for s in self.sides]
        for st in (jm["stats"], pm["stats"]):
            for k in self.TIMED:
                st["totals"].pop(k)
        assert pm["stats"] == jm["stats"]
        counts = []
        for s in self.sides:
            text = s["svc"].obs.registry.prometheus_text()
            counts.append({(n, tuple(sorted(lbl.items()))): int(v)
                           for n, lbl, v in parse_prometheus(text)
                           if n.startswith("service_")
                           and (n.endswith("_total") or n.endswith("_count"))})
        assert counts[1] == counts[0]
        assert counts[1][("service_requests_total", (("op", "stats"), ("status", "OK")))] \
            == self.n_checked + 1
        self.n_checked += 1

    # -- ops
    def free(self) -> int:
        st = self.sides[1]["svc"].status()["engine"]
        return st["free_slots"] - st["engine_queue"]

    def open(self, tenant):
        return self.send({"op": "open", "tenant": tenant})[0].get("sid")

    def append(self, sid, a):
        a = np.ascontiguousarray(a)
        return self.send({"op": "append", "sid": sid, "array": psvc._arr_meta(a)}, a.tobytes())

    def query(self, sid, scope="session"):
        return self.send({"op": "query", "sid": sid, "scope": scope})

    def close_sid(self, sid):
        return self.send({"op": "close", "sid": sid})

    def open_batch(self, tenants, first):
        metas, payload = [], b""
        for a in first:
            metas.append(None if a is None else psvc._arr_meta(a))
            payload += b"" if a is None else a.tobytes()
        return self.send({"op": "open_batch", "tenants": tenants, "first": metas},
                         payload)[0]["sids"]


def _wire_script(tw: WireTwin, admission: str, seed: int = 20261017):
    tw.send({"op": "ping"})
    a = tw.open("t0")
    tw.append(a, _data(1, 3 * CHUNK + 5))
    tw.query(a)
    b, c, d = tw.open_batch(["t1", "t2", "t3"], [_data(2, 2 * CHUNK + 9), None, _data(3, 40)])
    tw.append(c, _data(4, 30))                  # c is queued in the engine
    tw.query(c)                                 # ERR_QUEUED
    tw.close_sid(c)                             # ERR_QUEUED: it holds data
    tw.append(a, _data(0, 0))
    tw.query(a, "engine")
    tw.append(a, np.zeros((4, 3), np.int32))    # ERR_SHAPE
    tw.query(10_000)                            # ERR_UNKNOWN_SID
    tw.send({"op": "bogus"})                    # ERR_OP
    tw.send({"op": "open"} if admission == "scored" else {"op": "ping"})
    tw.close_sid(a)                             # c takes the slot
    tw.append(a, _data(5, 4))                   # ERR_CLOSED_SID
    tw.close_sid(d)                             # ERR_QUEUED: it holds data
    if admission == "scored":
        tw.close_sid(b)                         # d takes the slot (engine FIFO)
        parked = tw.park_open("cold")
        tw.close_sid(d)                         # frees a slot: "cold" wins it
        live = [c, tw.read_parked(parked)[0]["sid"]]
    else:
        live = [c, tw.open("late"), d]          # "late" queues behind d
        tw.close_sid(b)
    rng = np.random.default_rng(seed)
    for i in range(30):
        r = rng.random()
        if r < 0.45:
            tw.append(live[int(rng.integers(len(live)))],
                      _data(100 + i, int(rng.integers(0, 3 * CHUNK))))
        elif r < 0.75:
            tw.query(live[int(rng.integers(len(live)))], ("session", "engine")[i % 2])
        elif r < 0.85 and len(live) > 1:
            s = live[int(rng.integers(len(live)))]
            if tw.close_sid(s)[0]["code"] == "OK":      # a queued one may refuse
                live.remove(s)
        elif tw.free() > 0 or admission == "fifo":
            live.append(tw.open(f"w{i % 3}"))
    for _ in range(len(live)):          # admitted sessions first free slots
        live = [s for s in live if tw.close_sid(s)[0]["code"] != "OK"]
    assert not live
    assert tw.sides[1]["svc"].status()["engine"]["open_sessions"] == 0


@pytest.mark.parametrize("admission", ["fifo", "scored"])
def test_wire_twin(admission):
    tw = WireTwin(admission)
    try:
        _wire_script(tw, admission)
        assert tw.n_checked > 40
    finally:
        tw.close()


# ---------------------------------------------------------------------------
# Ingress policy (tests/test_service.py's classes, on the port)
# ---------------------------------------------------------------------------

class TestTokenBucket:
    def test_burst_then_deplete_then_refill(self):
        clk = FakeClock()
        b = psvc.TokenBucket(rate=10.0, burst=2.0, clock=clk)
        assert b.take() == 0.0
        assert b.take() == 0.0
        assert b.take() == pytest.approx(100.0)
        clk.t += 0.05
        assert b.take() == pytest.approx(50.0)
        clk.t += 0.1
        assert b.take() == 0.0

    def test_tokens_cap_at_burst(self):
        clk = FakeClock()
        b = psvc.TokenBucket(rate=100.0, burst=3.0, clock=clk)
        clk.t += 1000.0
        for _ in range(3):
            assert b.take() == 0.0
        assert b.take() > 0.0

    def test_same_hints_as_jax(self):
        clk = FakeClock()
        p = psvc.TokenBucket(rate=7.0, burst=3.0, clock=clk)
        j = jsvc.TokenBucket(rate=7.0, burst=3.0, clock=clk)
        rng = np.random.default_rng(3)
        for _ in range(200):
            clk.t += float(rng.random() * 0.3)
            cost = float(rng.integers(1, 4))
            assert p.take(cost) == j.take(cost)


class TestRateLimit:
    def test_retry_after_over_the_wire(self):
        clk = FakeClock()
        cfg = psvc.ServiceConfig(admission="fifo", rate_limit=10.0, rate_burst=2.0)
        with _service(primary_slots=2, cfg=cfg, clock=clk) as svc, _client(svc) as cli:
            sid = cli.open("a")
            cli.append(sid, _data(0, 8))
            with pytest.raises(err.RateLimitedError) as ei:
                cli.append(sid, _data(1, 8))
            assert ei.value.retry_after_ms == pytest.approx(100.0)
            assert err.status_of(ei.value) == err.ERR_RATELIMIT
            assert isinstance(cli.open("b"), int)    # tenants are isolated
            clk.t += 0.1
            cli.append(sid, _data(2, 8))


    def test_sessions_opened_before_start_keep_their_tenant(self):
        """A service in front of an engine that already holds sessions (a
        recovered one) rate-limits them by their tenant."""
        clk = FakeClock()
        eng = _port_engine(primary=2)
        sid = eng.open("warm")
        cfg = psvc.ServiceConfig(admission="fifo", rate_limit=10.0, rate_burst=1.0)
        with _serving(psvc, eng, cfg, clock=clk) as svc, _client(svc) as cli:
            cli.append(sid, _data(0, 8))
            with pytest.raises(err.RateLimitedError):
                cli.query(sid)


class TestBackpressure:
    def test_admission_queue_cap_rejects_with_retry_after(self):
        cfg = psvc.ServiceConfig(admission="scored", admit_queue_cap=1, retry_after_ms=25.0)
        with _service(primary_slots=1, cfg=cfg) as svc, _client(svc) as cli:
            sid_a = cli.open("a")
            parked = {}

            def _park():
                with _client(svc) as c2:
                    parked["sid"] = c2.open("b")

            t = threading.Thread(target=_park)
            t.start()
            assert _wait_for(lambda: _held(svc) == 1)
            with pytest.raises(err.BackpressureError) as ei:
                cli.open("c")
            assert ei.value.retry_after_ms == pytest.approx(25.0)
            cli.close(sid_a)
            t.join(timeout=60)
            assert not t.is_alive() and isinstance(parked["sid"], int)

    def test_max_pending_rejects_with_retry_after(self):
        """With the worker held on its first batch, the request queue fills
        to max_pending and the next requests are refused at once."""
        cfg = psvc.ServiceConfig(admission="fifo", max_pending=2, retry_after_ms=30.0)
        with _service(cfg=cfg) as svc, _client(svc, trace=False) as cli:
            entered, release = threading.Event(), threading.Event()
            run = svc._apply_batch

            def held_batch(batch):
                entered.set()
                release.wait(60)
                return run(batch)

            svc._apply_batch = held_batch
            cli.send_raw(psvc.encode_frame({"op": "ping", "id": 1}))
            assert entered.wait(60)
            for i in range(2, 6):
                cli.send_raw(psvc.encode_frame({"op": "ping", "id": i}))
            assert _wait_for(lambda: svc.status()["service"]["request_queue"] == 2)
            early = [cli.read_response()[0] for _ in range(2)]
            assert sorted(m["id"] for m in early) == [4, 5]
            assert all(m["code"] == "ERR_BACKPRESSURE" and m["retry_after_ms"] == 30.0
                       for m in early)
            release.set()
            late = [cli.read_response()[0] for _ in range(3)]
            assert sorted(m["id"] for m in late) == [1, 2, 3]
            assert all(m["pong"] for m in late)

    def test_stop_rejects_still_parked_opens(self):
        """stop() answers a parked open with the typed rejection, every
        time (20 services in turn), and promptly."""
        cfg = psvc.ServiceConfig(admission="scored", admit_queue_cap=4)
        for i in range(20):
            result = {}
            t0 = time.monotonic()
            with _service(primary_slots=1, cfg=cfg) as svc:
                with _client(svc) as cli:
                    cli.open("a")

                    def _park():
                        with _client(svc) as c2:
                            try:
                                c2.open("b")
                            except err.BackpressureError as e:
                                result["exc"] = e
                            except Exception as e:       # reported below
                                result["other"] = e

                    t = threading.Thread(target=_park)
                    t.start()
                    assert _wait_for(lambda: _held(svc) == 1)
            t.join(timeout=60)
            assert isinstance(result.get("exc"), err.BackpressureError), (i, result)
            assert result["exc"].retry_after_ms == pytest.approx(50.0)
            assert time.monotonic() - t0 < 30.0

    def test_requests_during_stop_are_refused(self):
        """A request that reaches a stopping service is refused with the
        typed rejection, never dropped."""
        with _service() as svc, _client(svc, trace=False) as cli:
            svc._stopping = True
            cli.send_raw(psvc.encode_frame({"op": "ping", "id": 7}))
            meta, _ = cli.read_response()
            assert (meta["id"], meta["code"]) == (7, "ERR_BACKPRESSURE")
            svc._stopping = False
            assert cli.ping()


class TestScoredAdmissionEndToEnd:
    def test_cold_tenant_wins_freed_slot(self):
        cfg = psvc.ServiceConfig(admission="scored")
        with _service(primary_slots=2, cfg=cfg) as svc, _client(svc) as cli:
            hog1 = cli.open("hog")
            hog2 = cli.open("hog")
            cli.append(hog1, _data(0, 3 * CHUNK))
            got = {}

            def _open(tag, tenant):
                with _client(svc) as c:
                    try:
                        got[tag] = c.open(tenant)
                    except err.SessionError as e:
                        got[tag] = e

            t_hog = threading.Thread(target=_open, args=("hog3", "hog"))
            t_hog.start()
            assert _wait_for(lambda: _held(svc) == 1)
            t_cold = threading.Thread(target=_open, args=("cold", "cold"))
            t_cold.start()
            assert _wait_for(lambda: _held(svc) == 2)
            cli.close(hog2)                        # ONE slot frees
            t_cold.join(timeout=60)
            assert not t_cold.is_alive() and isinstance(got["cold"], int)
            assert _held(svc) == 1                 # hog3 still parked
            cli.close(hog1)
            t_hog.join(timeout=60)
            assert isinstance(got["hog3"], int)


class TestProtocolFuzzLive:
    def test_malformed_frames_reject_without_state_damage(self):
        with _service(primary_slots=2) as svc, _client(svc) as good:
            eng = svc.engine
            model = OracleModel(2, CHUNK)
            data = _data(3, 2 * CHUNK + 7)
            sid = good.open("t0")
            assert sid == model.open("t0")
            good.append(sid, data)
            model.append(sid, data)
            fp0 = _fingerprint(eng)
            bad0, trunc0 = svc._mx.bad_frames.value(), svc._mx.truncated.value()
            a = _data(5, CHUNK)
            base = psvc.encode_frame({"op": "append", "sid": sid, "id": 1,
                                      "array": psvc._arr_meta(a)}, a.tobytes())
            rng = np.random.default_rng(20260808)
            rejected = truncated = 0
            for trial in range(24):
                raw = _client(svc)
                kind = trial % 4
                if kind == 0:                      # bit flip inside the body
                    mutated = bytearray(base)
                    pos = int(rng.integers(_FRAME.size, len(mutated)))
                    mutated[pos] ^= 1 << int(rng.integers(8))
                    raw.send_raw(bytes(mutated))
                elif kind == 1:                    # oversized length prefix
                    raw.send_raw(_FRAME.pack(
                        psvc.DEFAULT_MAX_FRAME + 1 + int(rng.integers(1 << 20)), 0))
                elif kind == 2:                    # half of A, then all of B
                    cut = int(rng.integers(_FRAME.size + 1, len(base)))
                    raw.send_raw(base[:cut] + base)
                else:                              # truncation, then hang up
                    cut = int(rng.integers(1, len(base)))
                    raw.send_raw(base[:cut])
                    raw.close_conn()
                    truncated += 1
                    continue
                rmeta, _ = raw.read_response()
                assert (rmeta["status"], rmeta["code"]) == (err.ERR_MALFORMED, "ERR_MALFORMED")
                rejected += 1
                with pytest.raises(ConnectionError):
                    raw.read_response()            # no resync point: hung up
                raw.close_conn()
            assert rejected == 18 and truncated == 6
            assert svc._mx.bad_frames.value() == bad0 + rejected
            assert _wait_for(lambda: svc._mx.truncated.value() >= trunc0 + truncated)
            assert _fingerprint(eng) == fp0
            np.testing.assert_array_equal(good.query(sid), model.query(sid))
            merged, stats = good.close(sid)
            np.testing.assert_array_equal(merged, model.close(sid))
            assert stats["tuples_appended"] == len(data)

    def test_bad_connection_magic(self):
        import socket as _socket
        with _service(primary_slots=2) as svc:
            fp0 = _fingerprint(svc.engine)
            s = _socket.create_connection(svc.address, timeout=CLIENT_TIMEOUT)
            s.sendall(b"GET / HTTP/1.1\r\n")
            dec = psvc.FrameDecoder()
            msg = None
            while msg is None:
                got = s.recv(1 << 16)
                assert got, "connection closed before the rejection"
                dec.feed(got)
                msg = dec.next()
            assert msg[0]["status"] == err.ERR_MALFORMED
            s.close()
            assert _fingerprint(svc.engine) == fp0


class TestTaxonomyOverTheWire:
    def test_wire_statuses_and_client_reconstruction(self):
        with _service(primary_slots=1) as svc, _client(svc) as cli:
            sid_a = cli.open("a")
            sid_b = cli.open("b")                # queued behind a
            cli.append(sid_a, _data(0, 4))
            cases = [(err.UnknownSessionError, lambda: cli.query(10_000)),
                     (err.QueuedSessionError, lambda: cli.query(sid_b)),
                     (err.ShapeMismatchError,
                      lambda: cli.append(sid_a, np.zeros((4, 3), np.int32)))]
            for cls, call in cases:
                with pytest.raises(cls) as ei:
                    call()
                assert err.status_of(ei.value) == cls.status
            cli.close(sid_a)
            with pytest.raises(err.ClosedSessionError):
                cli.append(sid_a, _data(0, 4))
            cli.send_raw(psvc.encode_frame({"op": "query", "sid": 10_000, "id": 990}))
            rmeta, _ = cli.read_response()
            assert (rmeta["status"], rmeta["code"]) == (err.ERR_UNKNOWN_SID, "ERR_UNKNOWN_SID")
            cli.send_raw(psvc.encode_frame({"op": "bogus", "id": 991}))
            rmeta, _ = cli.read_response()
            assert rmeta["status"] == err.ERR_OP
            assert cli.ping()                    # the frame was well formed


# ---------------------------------------------------------------------------
# The scrape sidecar and wire traces (tests/test_scrape.py,
# tests/test_wire_trace.py)
# ---------------------------------------------------------------------------

@pytest.fixture()
def traced_service():
    obs = obs_lib.Observability()
    eng = _port_engine(primary=8, aot=2, obs=obs)
    eng.warmup(dtype=np.int32, feat_shape=(2,))
    svc = psvc.SessionService(eng, psvc.ServiceConfig(scrape_port=0), obs=obs)
    host, port = svc.start()
    try:
        yield svc, host, port, obs
    finally:
        svc.stop()


def _roots(obs, n: int, **match):
    """The ``svc.request`` root spans, polled until ``n`` match: a request's
    span tree is deferred past its reply."""
    found = []

    def ready():
        found[:] = [e for e in obs.tracer.events() if e["name"] == "svc.request"
                    and all(e["args"].get(k) == v for k, v in match.items())]
        return len(found) >= n
    assert _wait_for(ready)
    return found


class TestSidecar:
    def test_metrics_healthz_statusz_and_404(self, traced_service):
        svc, host, port, obs = traced_service
        url = "http://%s:%d" % svc.scrape_address
        assert svc.scrape_address[1] != 0
        with _client(svc) as c:
            sid = c.open("statz")
            c.append(sid, _data(1, CHUNK))
            status, ctype, body = _get(url + "/statusz")
            c.close(sid)
        assert status == 200 and ctype == "application/json"
        page = json.loads(body)
        assert {"engine", "service", "skew"} <= set(page)
        assert page["service"]["admission"] == "scored" and page["skew"]["slo_ms"] > 0
        status, _, body = _get(url + "/metrics")
        assert status == 200
        names = {n for n, _, _ in parse_prometheus(body)}
        assert {"service_requests_total", "service_request_ms_count",
                "service_batch_ops_count", "appends_total"} <= names
        assert _get(url + "/healthz")[0] == 200
        status, _, body = _get(url + "/nope")
        assert status == 404 and "/metrics" in body

    def test_metrics_parse_under_live_wire_load(self, traced_service):
        svc, host, port, obs = traced_service
        url = "http://%s:%d/metrics" % svc.scrape_address
        data = _data(5, 2 * CHUNK)
        errors = []

        def storm(w):
            try:
                with _client(svc) as c:
                    for r in range(6):
                        sid = c.open(f"w{w}r{r}")
                        c.append(sid, data)
                        c.query(sid)
                        c.close(sid)
            except Exception as e:          # reported after the join
                errors.append(e)

        threads = [threading.Thread(target=storm, args=(w,)) for w in range(4)]
        for t in threads:
            t.start()
        bodies = []
        while any(t.is_alive() for t in threads):
            status, _, body = _get(url)
            if status == 200:
                parse_prometheus(body)          # strict, mid-load
                bodies.append(body)
        for t in threads:
            t.join(timeout=60)
        assert not errors
        status, _, body = _get(url)
        assert status == 200
        total = sum(v for n, _, v in parse_prometheus(body) if n == "service_requests_total")
        assert total == 4 * 6 * 4

    def test_healthz_goes_with_the_service(self):
        eng = _port_engine(primary=4)
        svc = psvc.SessionService(eng, psvc.ServiceConfig(scrape_port=0))
        svc.start()
        url = "http://%s:%d/healthz" % svc.scrape_address
        assert _get(url)[0] == 200
        svc.stop()
        assert not svc._started
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(url, timeout=5)
        with pytest.raises(RuntimeError, match="scrape"):
            svc.scrape_address

    def test_no_sidecar_without_port(self):
        with _service() as svc:
            with pytest.raises(RuntimeError, match="scrape"):
                svc.scrape_address

    def test_report_reads_the_live_service(self, traced_service, capsys):
        svc, host, port, obs = traced_service
        with _client(svc) as c:
            sid = c.open("rep")
            c.append(sid, _data(2, 3 * CHUNK))
            c.query(sid)
            c.close(sid)
        assert report.main(["--url", "http://%s:%d" % svc.scrape_address]) == 0
        out = capsys.readouterr().out
        assert "== engine health report ==" in out
        assert "service: " in out and "admission=scored" in out


class TestWireTrace:
    def test_response_echoes_minted_context(self, traced_service):
        svc, host, port, obs = traced_service
        with _client(svc) as c:
            sid = c.open("t0")
            sent = dict(c.last_trace)
            rmeta, _ = c.request({"op": "append", "sid": sid,
                                  "array": {"dtype": "<i4", "shape": [0, 2]}})
            assert rmeta["trace"]["trace_id"] == c.last_trace["trace_id"]
            assert sent["trace_id"] != c.last_trace["trace_id"]
            c.close(sid)

    def test_root_span_carries_ids_and_breakdown(self, traced_service):
        svc, host, port, obs = traced_service
        with _client(svc) as c:
            sid = c.open("t1")
            c.append(sid, _data(7, 3 * CHUNK))
            np.testing.assert_array_equal(c.query(sid), _oracle([_data(7, 3 * CHUNK)[:, 0]]))
            qt = dict(c.last_trace)
            c.close(sid)
        (q,) = _roots(obs, 1, trace_id=qt["trace_id"])
        assert (q["args"]["op"], q["args"]["status"]) == ("query", "OK")
        assert q["args"]["parent_span"] == qt["span_id"]
        for k in ("queue_ms", "engine_ms", "reply_ms"):
            assert q["args"][k] >= 0.0
        legs = [e for e in obs.tracer.events()
                if e["name"] == "svc.engine" and e["args"].get("trace_id") == qt["trace_id"]]
        assert len(legs) == 1
        assert {"svc.batch", "svc.conn", "engine.flush"} & obs.tracer.span_names()

    def test_error_response_still_traced_and_old_client(self, traced_service):
        svc, host, port, obs = traced_service
        with _client(svc) as c:
            with pytest.raises(err.UnknownSessionError):
                c.query(999)
        assert _roots(obs, 1, op="query")[-1]["args"]["status"] == "ERR_UNKNOWN_SID"
        with _client(svc, trace=False) as c:
            sid = c.open("legacy")
            assert c.last_trace is None
            c.append(sid, _data(8, CHUNK))
            _, stats = c.close(sid)
            assert stats["tuples_appended"] == CHUNK
        assert len(_roots(obs, 4)) >= 4

    def test_tracing_disabled_drops_the_echo(self, traced_service):
        svc, host, port, obs = traced_service
        obs.enabled = False
        try:
            with _client(svc) as c:
                rmeta, _ = c.request({"op": "ping"})
                assert "trace" not in rmeta
        finally:
            obs.enabled = True

    def test_garbage_trace_fields_never_err_malformed(self, traced_service):
        svc, host, port, obs = traced_service
        garbage = [42, "deadbeef", [], {}, {"trace_id": 123, "span_id": 456},
                   {"trace_id": "xyzzy!", "span_id": "ok"}, {"trace_id": "a" * 64},
                   {"trace_id": "", "span_id": ""}, {"trace_id": {"nested": "junk"}},
                   {"span_id": "0badcafe"}]
        rng = np.random.default_rng(23)
        for i in range(16):
            junk = bytes(rng.integers(32, 127, size=20, dtype=np.uint8)).decode("ascii")
            garbage.append({"trace_id": junk, "span_id": junk[:4]})
        with _client(svc, trace=False) as c:
            for i, raw in enumerate(garbage):
                c.send_raw(psvc.encode_frame({"op": "ping", "id": 1000 + i, "trace": raw}))
                rmeta, _ = c.read_response()
                assert rmeta.get("status", 0) == 0, (raw, rmeta)
                tid = rmeta["trace"]["trace_id"]
                assert 1 <= len(tid) <= 32 and all(ch in "0123456789abcdef" for ch in tid)
            sid = c.open("after-fuzz")
            c.close(sid)


# ---------------------------------------------------------------------------
# The storm over the wire (the port's OracleHarness in network mode)
# ---------------------------------------------------------------------------

def test_storm_walk_jax_fails_on():
    """The example on which JAX's TestStormStatefulService fails (ROADMAP
    §3): a storm of 4 with 43 tuples each, a session-scope query, a
    per-session flush, a close, then recovery behind a new service.  The
    port's recovered backlogs equal the model's."""
    with tempfile.TemporaryDirectory() as d:
        h = OracleHarness(d, network=True)
        try:
            first = [_data(197 + i, 43) for i in range(4)]
            tenants = [f"s{197 % 5}-{i}" for i in range(4)]
            ep = h.ep()
            got, want = h.both(lambda: ep.open_batch(tenants, first=first),
                               lambda: h.model.open_batch(tenants, first))
            assert got == want == [0, 1, 2, 3]
            ep = h.ep()
            h.both(lambda: ep.query(0), lambda: h.model.query(0))
            h.both(lambda: h.eng.flush_session(1), lambda: h.model.flush_session(1))
            ep = h.ep()
            h.both(lambda: ep.close(0), lambda: h.model.close(0))
            h.recover()
            assert h.eng.sessions[1].backlog_tuples == h.model.sessions[1]["pending"] == 0
            for sid in (1, 2):
                ep = h.ep()
                h.both(lambda: ep.query(sid), lambda: h.model.query(sid))
        finally:
            h.shutdown()


def test_storm_random_walk_over_the_wire():
    """A seeded walk of 80 ops through the wire: storms, ragged appends,
    both query scopes, closes, flushes, forced disconnects mid-append and
    two recoveries across a service restart, the model checked after
    every op."""
    rng = np.random.default_rng(20261018)
    counts = {"net_drop": 0, "recover": 0, "open_batch": 0}
    with tempfile.TemporaryDirectory() as d:
        h = OracleHarness(d, network=True)
        try:
            def sid():
                sids = sorted(h.model.sessions)
                return int(sids[rng.integers(len(sids))]) if sids else 10_000

            for i in range(80):
                op = ("open", "open_batch", "append", "append", "query", "query_engine",
                      "close", "flush", "flush_session", "net_drop", "recover",
                      "bad")[int(rng.integers(12))]
                if op == "recover" and counts["recover"] >= 2:
                    op = "open_batch"
                counts[op] = counts.get(op, 0) + 1
                ep, s = h.ep(), sid()
                if op == "open":
                    t = f"t{rng.integers(3)}"
                    got, want = h.both(lambda: ep.open(t), lambda: h.model.open(t))
                    assert got == want
                elif op == "open_batch":
                    k = int(rng.integers(1, 5))
                    first = [None if rng.integers(4) == 0 else
                             _data(int(rng.integers(1 << 30)), int(rng.integers(0, 3 * CHUNK)))
                             for _ in range(k)]
                    ts = [f"s{rng.integers(3)}" for _ in range(k)]
                    got, want = h.both(lambda: ep.open_batch(ts, first=first),
                                       lambda: h.model.open_batch(ts, first))
                    assert got == want
                elif op == "append":
                    a = _data(int(rng.integers(1 << 30)), int(rng.integers(0, 3 * CHUNK)))
                    h.both(lambda: ep.append(s, a), lambda: h.model.append(s, a))
                elif op in ("query", "query_engine"):
                    scope = "engine" if op == "query_engine" else "session"
                    h.both(lambda: ep.query(s, scope=scope), lambda: h.model.query(s, scope))
                elif op == "close":
                    h.both(lambda: ep.close(s), lambda: h.model.close(s))
                elif op == "flush":
                    h.both(h.eng.flush, h.model.flush)
                elif op == "flush_session":
                    h.both(lambda: h.eng.flush_session(s), lambda: h.model.flush_session(s))
                elif op == "net_drop":
                    h.net_drop(s, _data(int(rng.integers(1 << 30)),
                                        int(rng.integers(1, 2 * CHUNK))))
                elif op == "recover":
                    h.recover()
                else:
                    h.both(lambda: ep.append(10_000 + s, _data(0, 4)),
                           lambda: h.model.append(10_000 + s, _data(0, 4)))
            assert counts["net_drop"] >= 1 and h.n_recovers >= 1 and counts["open_batch"] >= 3
        finally:
            h.shutdown()


if HAVE_HYPOTHESIS:
    from hypothesis import HealthCheck, settings
    from hypothesis.stateful import run_state_machine_as_test

    from test_torch_session import _PortStorm

    class _PortStormService(_PortStorm):
        durable = True
        network = True

    def test_storm_machine_over_the_wire():
        """The port's storm machine through the service: a durable engine,
        two alternating clients, disconnects mid-append, recovery across a
        service restart; every op checked against the oracle model."""
        run_state_machine_as_test(_PortStormService, settings=settings(
            max_examples=10, stateful_step_count=15, deadline=None, database=None,
            suppress_health_check=list(HealthCheck)))


def test_two_concurrent_clients_bit_exact():
    """Two clients append to and query two sessions from two threads; the
    single worker serialises them, and both land bit-exact on the oracle."""
    h = OracleHarness(network=True)
    try:
        ep = h.ep()
        sid_a = h.both(lambda: ep.open("a"), lambda: h.model.open("a"))[0]
        ep = h.ep()
        sid_b = h.both(lambda: ep.open("b"), lambda: h.model.open("b"))[0]
        parts = {sid_a: [], sid_b: []}
        errs = []

        def pump(cli, sid, seed):
            try:
                for i in range(10):
                    d = _data(seed + i, int(17 + 13 * i) % (2 * CHUNK))
                    cli.append(sid, d)
                    parts[sid].append(d[:, 0])
                    np.testing.assert_array_equal(cli.query(sid), _oracle(list(parts[sid])))
            except Exception as e:          # reported after the join
                errs.append(e)

        threads = [threading.Thread(target=pump, args=(h.clients[0], sid_a, 1000)),
                   threading.Thread(target=pump, args=(h.clients[1], sid_b, 2000))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and errs == []
        for sid in (sid_a, sid_b):           # each thread ended on a query
            h.model.sessions[sid]["keys"].extend(parts[sid])
            h.model.sessions[sid]["pending"] = 0
        h.check()
        for sid in (sid_a, sid_b):
            ep = h.ep()
            h.both(lambda: ep.close(sid), lambda: h.model.close(sid))
    finally:
        h.shutdown()


def test_many_clients_stress():
    """Six client threads (more than this machine's cores), each with its
    own connection and session, append and query under a shortened switch
    interval; every answer is oracle-exact and the service's counters add
    up to the requests sent."""
    n_threads, rounds = 6, 12
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _service(primary_slots=n_threads) as svc:
            errs = []

            def pump(k):
                try:
                    with _client(svc) as c:
                        sid, parts = c.open(f"s{k}"), []
                        for i in range(rounds):
                            d = _data(100 * k + i, int(5 + 29 * i) % (2 * CHUNK))
                            c.append(sid, d)
                            parts.append(d[:, 0])
                            np.testing.assert_array_equal(
                                c.query(sid, scope=("session", "engine")[i % 2]), _oracle(parts))
                        np.testing.assert_array_equal(c.close(sid)[0], _oracle(parts))
                except Exception as e:          # reported after the join
                    errs.append(e)

            threads = [threading.Thread(target=pump, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads) and errs == []
            text = svc.obs.registry.prometheus_text()
            sent = sum(v for n, _, v in parse_prometheus(text) if n == "service_requests_total")
            assert sent == n_threads * (2 + 2 * rounds)
            assert svc.status()["engine"]["open_sessions"] == 0
    finally:
        sys.setswitchinterval(interval)


# ---------------------------------------------------------------------------
# Threads: the worker owns the engine, status() touches no tensor
# ---------------------------------------------------------------------------

def test_status_touches_no_tensor(monkeypatch):
    """status() (and the stats op's body) read host state only: with every
    device sync and tensor read made to raise, they still answer, and so
    does /statusz from the sidecar's thread."""
    obs = obs_lib.Observability()
    eng = _port_engine(primary=2, obs=obs)
    with _serving(psvc, eng, psvc.ServiceConfig(scrape_port=0)) as svc, _client(svc) as c:
        sid = c.open("a")
        c.append(sid, _data(1, 2 * CHUNK + 3))
        c.query(sid)
        c.append(sid, _data(2, 50))

        def boom(*a, **k):
            raise AssertionError("status() touched a tensor or the device")
        for name in ("item", "cpu", "numpy", "tolist", "cuda", "to"):
            monkeypatch.setattr(torch.Tensor, name, boom)
        monkeypatch.setattr(torch.cuda, "synchronize", boom)
        st = svc.status()
        assert st["engine"]["open_sessions"] == 1 and st["service"]["held_opens"] == 0
        assert svc._stats()["totals"]["tuples_flushed"] == 2 * CHUNK + 3
        status, _, body = _get("http://%s:%d/statusz" % svc.scrape_address)
        assert status == 200 and json.loads(body)["engine"]["open_sessions"] == 1
        monkeypatch.undo()
        c.close(sid)


def test_every_engine_call_runs_on_the_worker():
    """Every engine call the service makes runs on the one svc-engine
    thread, never on the event loop or a client's."""
    eng = _port_engine(primary=2, aot=2)
    eng.warmup(dtype=np.int32, feat_shape=(2,))
    seen = []
    for name in ("open", "open_batch", "append", "query", "close", "flush"):
        fn = getattr(eng, name)

        def rec(*a, _fn=fn, _name=name, **k):
            seen.append((_name, threading.current_thread().name))
            return _fn(*a, **k)
        setattr(eng, name, rec)
    with _serving(psvc, eng) as svc, _client(svc) as c, _client(svc) as c2:
        sids = c.open_batch(["x", "y"], first=[_data(1, CHUNK + 1), None])
        c.append(sids[1], _data(2, 9))
        c2.send_raw(psvc.encode_frame({"op": "query", "sid": sids[0], "id": 1}))
        c.query(sids[1])
        c2.read_response()
        for s in sids:
            c.close(s)
    assert {n for n, _ in seen} >= {"open_batch", "append", "query", "close"}
    assert all(t.startswith("svc-engine") for _, t in seen), seen
