"""Network front door of the session engine.

The PyTorch counterpart of ``repro/serve/service.py``, with its API, knobs,
defaults, wire protocol, metric names and error taxonomy.
``SessionService`` puts an asyncio TCP endpoint in front of one
``SessionEngine`` / ``DurableSessionEngine`` so that concurrent clients can
``open / open_batch / append / query / close`` over the wire.  Arrays cross
the socket as numpy C-order bytes; no tensor does.

Wire protocol v1 (byte for byte the JAX package's):

* Both sides open with the 8-byte magic ``DSRV\\x01\\x00\\x00\\x00``
  (client first; the server answers with its own before any frame).
* Every message is one frame in the WAL's record layout::

      [u32 body_len][u32 crc32(body)]
      body = [u32 header_len][JSON header][payload bytes]

  The header is compact JSON with sorted keys.  Arrays travel as raw
  C-order bytes in the payload, described by a ``{"dtype", "shape"}``
  entry in the header.  A frame that fails any check -- oversized or
  undersized length prefix, CRC mismatch, truncated or undecodable
  header -- raises ``ProtocolError`` in the incremental ``FrameDecoder``
  before any engine state is touched; the server answers ``ERR_MALFORMED``
  and drops the connection (a corrupt byte stream has no resync point).

Request path (socket to lane):

* Connection handlers only parse frames and enforce ingress policy:
  per-tenant token buckets (``ERR_RATELIMIT`` with a RETRY-AFTER hint) and
  a bounded request queue (``ERR_BACKPRESSURE``).
* Every engine call runs on ONE single-writer worker thread: the event loop
  drains the request queue in batches and hands each batch to a 1-thread
  executor, which coalesces work -- contiguous ``open`` runs become one
  ``open_batch`` storm (``admission="fifo"``), and >= 2 queries in a batch
  share one engine-wide forced flush before their per-session snapshots.
  When the engine lives on a CUDA device the worker runs each batch under
  that device, so its kernels go to the worker thread's current stream of
  the engine's card; no other thread touches a tensor.  ``status()`` and
  the scrape sidecar read host state only.
* Admission is the paper's Eq. 2 balancing move lifted to the service
  (``core.scheduler.admission_score`` / ``plan_admission``): with
  ``admission="scored"`` (default) an ``open`` that cannot get a slot parks
  in a bounded service-side queue, and every freed slot goes to the COLDEST
  tenant rather than strictly FIFO.  ``admission="fifo"`` passes opens
  straight to the engine's FIFO overflow.  ``open_batch`` always takes the
  engine's FIFO path.

The service builds no kernel: call the engine's ``warmup()`` before
``start()``, so that no nvcc build or library load stalls the worker while
connections wait::

    eng = DurableSessionEngine(spec, directory=..., aot_buckets=8, ...)
    eng.warmup(dtype=np.int32, feat_shape=(2,))
    with SessionService(eng, ServiceConfig(scrape_port=0)) as svc:
        c = ServiceClient(*svc.address)
        sid = c.open("tenant-a")
        c.append(sid, data)
        hist = c.query(sid)

``stop()`` drains the queued requests through the engine, answers every
still-parked open with ``ERR_BACKPRESSURE`` and waits (bounded) until every
answered request's frame is written before it closes the connections.
Requests that arrive while the service stops are refused with
``ERR_BACKPRESSURE`` too.

Failures map onto the one error taxonomy of ``serve/errors.py``: the server
writes ``status_of(exc)`` into the response, the clients re-raise
``error_for_status`` -- remote callers catch exactly the classes in-process
callers catch.  Metrics and spans go to the engine's ``Observability``
bundle by default: ``service_requests_total{op,status}``,
``service_request_ms{op}``, the queue-depth gauges, ``service_batch_ops``,
and the ``svc.*`` spans.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import socket
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.core import scheduler
from repro_torch.obs.scrape import ScrapeServer
from repro_torch.obs.skew import SkewMonitor
from repro_torch.obs.trace import adopt_trace, mint_span_id, new_trace_context
from repro_torch.serve import errors as err
from repro_torch.serve.errors import (BackpressureError, ProtocolError,
                                      RateLimitedError, UnknownOpError, status_of)

MAGIC = b"DSRV\x01\x00\x00\x00"           # 8-byte hello: magic + proto v1
_FRAME = struct.Struct("<II")             # body length, crc32(body)
_HEAD = struct.Struct("<I")               # json header length
DEFAULT_MAX_FRAME = 8 << 20               # oversize length prefixes rejected

OPS = ("open", "open_batch", "append", "query", "close", "ping", "stats")

# how long stop() waits for the answered requests' frames to be written, and
# then for the connections to drop
_STOP_GRACE_S = 10.0


# ---------------------------------------------------------------------------
# Wire codec
# ---------------------------------------------------------------------------

def encode_frame(meta: Dict[str, Any], payload: bytes = b"") -> bytes:
    """One wire frame: the WAL record layout pointed at a socket."""
    head = json.dumps(meta, separators=(",", ":"), sort_keys=True).encode("utf-8")
    body = _HEAD.pack(len(head)) + head + payload
    return _FRAME.pack(len(body), zlib.crc32(body)) + body


def _arr_meta(a: np.ndarray) -> Dict[str, Any]:
    return {"dtype": a.dtype.str, "shape": list(a.shape)}


def _arr_from(meta: Dict[str, Any], payload: bytes) -> np.ndarray:
    try:
        dt = np.dtype(meta["dtype"])
        shape = tuple(int(d) for d in meta["shape"])
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"bad array header {meta!r}: {e}") from None
    want = dt.itemsize * int(np.prod(shape, dtype=np.int64)) if shape else dt.itemsize
    if want != len(payload):
        raise ProtocolError(
            f"array payload is {len(payload)} bytes, header {meta!r} needs {want}")
    return np.frombuffer(payload, dtype=dt).reshape(shape).copy()


class FrameDecoder:
    """Incremental frame parser: feed arbitrary byte splits (half-frames
    across packets are the normal case), get whole (meta, payload) messages
    out.  Any malformed frame raises ``ProtocolError`` and poisons the
    decoder -- after corruption the stream has no frame boundary to recover
    to."""

    def __init__(self, max_frame: int = DEFAULT_MAX_FRAME):
        self.max_frame = int(max_frame)
        self._buf = bytearray()
        self._dead = False

    @property
    def buffered(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> None:
        if self._dead:
            raise ProtocolError("decoder poisoned by an earlier bad frame")
        self._buf.extend(data)

    def _die(self, msg: str) -> ProtocolError:
        self._dead = True
        return ProtocolError(msg)

    def next(self) -> Optional[Tuple[Dict[str, Any], bytes]]:
        """The next complete message, or None until more bytes arrive."""
        if self._dead:
            raise ProtocolError("decoder poisoned by an earlier bad frame")
        if len(self._buf) < _FRAME.size:
            return None
        blen, crc = _FRAME.unpack_from(self._buf, 0)
        if blen < _HEAD.size:
            raise self._die(f"frame body length {blen} is shorter than a "
                            f"header length prefix ({_HEAD.size} bytes)")
        if blen > self.max_frame:
            raise self._die(f"frame body length {blen} exceeds the "
                            f"{self.max_frame}-byte frame cap")
        if len(self._buf) < _FRAME.size + blen:
            return None
        body = bytes(self._buf[_FRAME.size:_FRAME.size + blen])
        if zlib.crc32(body) != crc:
            raise self._die("frame CRC mismatch (corrupt body)")
        (hlen,) = _HEAD.unpack_from(body, 0)
        if _HEAD.size + hlen > blen:
            raise self._die(f"header length {hlen} overruns the {blen}-byte frame body")
        try:
            meta = json.loads(body[_HEAD.size:_HEAD.size + hlen])
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise self._die(f"undecodable frame header: {e}") from None
        if not isinstance(meta, dict):
            raise self._die(f"frame header is {type(meta).__name__}, not an object")
        del self._buf[:_FRAME.size + blen]
        return meta, body[_HEAD.size + hlen:]


# ---------------------------------------------------------------------------
# Ingress policy
# ---------------------------------------------------------------------------

class TokenBucket:
    """Per-tenant token bucket: ``rate`` tokens/s up to ``burst``.
    ``take`` returns 0.0 on success or the RETRY-AFTER hint in ms."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate, self.burst, self._clock = float(rate), float(burst), clock
        self.tokens = float(burst)
        self._t = clock()

    def take(self, cost: float = 1.0) -> float:
        now = self._clock()
        self.tokens = min(self.burst, self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= cost:
            self.tokens -= cost
            return 0.0
        return (cost - self.tokens) / self.rate * 1000.0


@dataclasses.dataclass
class ServiceConfig:
    """Knobs of the front door (the JAX package's, with its defaults).

    Attributes:
      host/port: bind address; port 0 picks a free port (``start()``
        returns the resolved address).
      admission: ``"scored"`` (Eq. 2 admission controller, default) or
        ``"fifo"`` (engine FIFO pass-through).
      admit_queue_cap: most opens parked in the scored admission queue;
        beyond it opens are rejected with ``ERR_BACKPRESSURE``.
      max_pending: bound on the request queue between the event loop and
        the engine worker; full -> ``ERR_BACKPRESSURE``.
      coalesce_max: most requests the worker drains into one batch.
      rate_limit/rate_burst: per-tenant token bucket (tokens/s, cap);
        ``rate_limit=None`` disables rate limiting.
      max_frame: wire frame cap (oversized length prefixes rejected).
      retry_after_ms: RETRY-AFTER hint attached to backpressure rejections
        (rate-limit rejections compute their own).
      scrape_port: when not None, ``start()`` also boots an
        ``obs.scrape.ScrapeServer`` (``/metrics``, ``/healthz``,
        ``/statusz``) on this port (0 picks a free one); the resolved
        address is ``SessionService.scrape_address``.
      slo_ms: per-request latency SLO fed to the skew monitor's burn
        counters (``slo_violations_total``).
    """

    host: str = "127.0.0.1"
    port: int = 0
    admission: str = "scored"
    admit_queue_cap: int = 1024
    max_pending: int = 4096
    coalesce_max: int = 256
    rate_limit: Optional[float] = None
    rate_burst: float = 64.0
    max_frame: int = DEFAULT_MAX_FRAME
    retry_after_ms: float = 50.0
    scrape_port: Optional[int] = None
    slo_ms: float = 100.0

    def __post_init__(self):
        if self.admission not in ("scored", "fifo"):
            raise ValueError(f"admission {self.admission!r} not in ('scored', 'fifo')")


class _ServiceMetrics:
    """Service metric families; names, help strings and labels are the
    JAX service's, so a scrape of either parses into the same series."""

    def __init__(self, reg):
        c, g, h = reg.counter, reg.gauge, reg.histogram
        self.requests = c("service_requests_total",
                          "wire requests by op and response status",
                          labels=("op", "status"))
        self.request_ms = h("service_request_ms",
                            "server-side latency, ingress to response",
                            labels=("op",))
        self.queue_depth = g("service_queue_depth",
                             "requests waiting for the engine worker")
        self.admit_depth = g("service_admission_queue_depth",
                             "opens parked by the scored admission controller")
        self.conns = g("service_connections", "open client connections")
        self.batch_ops = h("service_batch_ops",
                           "requests coalesced per engine-worker batch")
        self.bad_frames = c("service_bad_frames_total",
                            "malformed frames rejected by the codec")
        self.truncated = c("service_truncated_conns_total",
                           "connections that vanished mid-frame")


class _Stop:
    pass


_STOP = _Stop()


@dataclasses.dataclass
class _Req:
    """One in-flight wire request: the queue item between the event loop
    and the engine worker, plus the trace/timing envelope its root span is
    assembled from.  ``trace`` is None whenever tracing is off -- the
    request then pays no stamping on the hot path."""

    meta: Dict[str, Any]
    payload: bytes
    fut: asyncio.Future
    # {"trace_id", "parent_id", "span_id"}; None = tracing disabled
    trace: Optional[Dict[str, Optional[str]]] = None
    t0_ns: int = 0           # ingress (dispatch entry, event loop)
    t_enq_ns: int = 0        # request-queue put
    t_deq_ns: int = 0        # engine-worker pickup
    t_eng0_ns: int = 0       # engine apply start (engine thread)
    t_eng1_ns: int = 0       # engine apply end
    t_eng_tid: int = 0       # engine thread id (the span's track)
    # span ids of SHARED engine spans this request rode (coalesced flush,
    # open storm): the root links these instead of duplicating them
    links: List[str] = dataclasses.field(default_factory=list)


def _build_request_spans(p: tuple) -> list:
    """Materialize one request's span tree from the deferred stamp record
    (``SpanTracer.defer``) into ``complete_batch`` tuples: queue wait and
    reply write nest in the ``svc.request`` root on the event-loop track;
    ``svc.engine`` sits on the engine thread's track, where the
    ``engine.*`` spans it covers live, and correlates through the shared
    ``trace_id``/``parent`` args.  Shared coalesced spans are referenced
    through ``links``."""
    (tr, op, status, t0, t_enq, t_deq, t_eng0, t_eng1, eng_tid,
     t_w0, t_w1, loop_tid, links) = p
    base = {"trace_id": tr["trace_id"], "parent": tr["span_id"]}
    queue_ms = engine_ms = 0.0
    spans = []
    if t_deq and t_enq:
        queue_ms = (t_deq - t_enq) / 1e6
        spans.append(("svc.queue", "service", t_enq, t_deq, loop_tid, base))
    if t_eng1 and t_eng0:
        engine_ms = (t_eng1 - t_eng0) / 1e6
        spans.append(("svc.engine", "service", t_eng0, t_eng1,
                      eng_tid or loop_tid, dict(base, op=op)))
    reply_ms = (t_w1 - t_w0) / 1e6
    spans.append(("svc.reply", "service", t_w0, t_w1, loop_tid, base))
    args: Dict[str, Any] = {
        "op": op, "status": status,
        "trace_id": tr["trace_id"], "span_id": tr["span_id"],
        "parent_span": tr["parent_id"],
        "queue_ms": round(queue_ms, 3),
        "engine_ms": round(engine_ms, 3),
        "reply_ms": round(reply_ms, 3),
    }
    if links:
        args["links"] = list(links)
    spans.append(("svc.request", "service", t0, t_w1, loop_tid, args))
    return spans


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

class SessionService:
    """One engine behind an asyncio TCP front door.

    The server runs on its own thread (``svc-loop``, its own event loop) and
    every engine call on one worker thread (``svc-engine``), so tests and
    tools drive it from ordinary synchronous code (see the module
    docstring).  ``obs=None`` shares the ENGINE's observability bundle so
    that service and engine metrics land in one registry.  A service built
    over a recovered engine knows the tenant of each session the engine
    holds, so their rate limits carry across a restart.
    """

    def __init__(self, engine, config: Optional[ServiceConfig] = None, *,
                 obs=None, clock=time.monotonic):
        self.engine = engine
        self.cfg = config or ServiceConfig()
        self.obs = engine.obs if obs is None else obs_lib.resolve(obs)
        self._mx = _ServiceMetrics(self.obs.registry) if self.obs.enabled else None
        self.skew = SkewMonitor(self.obs.registry, slo_ms=self.cfg.slo_ms) \
            if self.obs.enabled else None
        self._scrape: Optional[ScrapeServer] = None
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._sid_tenant: Dict[int, str] = {
            sid: s.tenant for sid, s in engine.sessions.items()}
        # opens parked by the scored controller, arrival order
        self._held: List[_Req] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._thread: Optional[threading.Thread] = None
        self._queue: Optional[asyncio.Queue] = None
        self._worker_task: Optional[asyncio.Task] = None
        # the single writer: every engine touch goes through this thread
        self._eng_exec = ThreadPoolExecutor(max_workers=1, thread_name_prefix="svc-engine")
        dev = getattr(engine, "device", None)
        self._cuda_device = dev if isinstance(dev, torch.device) and dev.type == "cuda" \
            else None
        self._addr: Optional[Tuple[str, int]] = None
        self._writers: Set[asyncio.StreamWriter] = set()
        self._dispatching: Set[asyncio.Task] = set()
        self._loop_tid = 0
        self._conn_seq = 0
        self._n_conns = 0
        self._started = False
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        if self._addr is None:
            raise RuntimeError("service not started; call start() first")
        return self._addr

    def start(self) -> Tuple[str, int]:
        if self._started:
            return self.address
        ready = threading.Event()
        boot: Dict[str, Any] = {}

        def _run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            try:
                boot["addr"] = loop.run_until_complete(self._boot())
            except Exception as e:             # pragma: no cover - bind error
                boot["exc"] = e
                ready.set()
                return
            ready.set()
            loop.run_forever()
            # drain cancelled tasks so the loop closes clean
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
            loop.close()

        self._thread = threading.Thread(target=_run, name="svc-loop", daemon=True)
        self._thread.start()
        ready.wait()
        if "exc" in boot:
            raise boot["exc"]
        self._addr = boot["addr"]
        self._started = True
        if self.cfg.scrape_port is not None:
            self._scrape = ScrapeServer(
                self.obs.registry, status_fn=self.status,
                health_fn=lambda: self._started,
                host=self.cfg.host, port=self.cfg.scrape_port)
            self._scrape.start()
        return self._addr

    @property
    def scrape_address(self) -> Tuple[str, int]:
        """The (host, port) of the scrape sidecar (needs
        ``ServiceConfig.scrape_port`` set and the service started)."""
        if self._scrape is None:
            raise RuntimeError(
                "no scrape sidecar: set ServiceConfig.scrape_port and "
                "start() the service")
        return self._scrape.address

    async def _boot(self) -> Tuple[str, int]:
        self._queue = asyncio.Queue(maxsize=0)   # bounded by max_pending
        # deferred request spans carry an explicit track id (they are
        # materialized on whatever thread reads the trace)
        self._loop_tid = threading.get_ident()
        self._worker_task = asyncio.get_running_loop().create_task(self._worker())
        self._server = await asyncio.start_server(
            self._handle_conn, self.cfg.host, self.cfg.port)
        host, port = self._server.sockets[0].getsockname()[:2]
        return host, port

    def stop(self) -> None:
        """Graceful stop: drain queued requests through the engine, answer
        still-parked opens with ``ERR_BACKPRESSURE`` (each frame written
        before the connections close), close the listener and the
        connections, stop the loop."""
        if not self._started or self._loop is None:
            return
        self._started = False       # healthz flips unhealthy right away
        if self._scrape is not None:
            self._scrape.stop()
            self._scrape = None
        fut = asyncio.run_coroutine_threadsafe(self._shutdown(), self._loop)
        fut.result(timeout=60)
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=60)
        self._eng_exec.shutdown(wait=True)

    async def _shutdown(self) -> None:
        # Server.wait_closed() waits for every connection to drop, and a
        # client whose open is parked waits for its answer: close the
        # listener, answer, then close the connections ourselves.
        self._stopping = True
        if self._server is not None:
            self._server.close()
        await self._queue.put(_STOP)
        if self._worker_task is not None:
            await self._worker_task
        held, self._held = self._held, []
        for req in held:
            if not req.fut.done():
                req.fut.set_result(self._err_response(req.meta, BackpressureError(
                    "service shutting down with the open still parked in the "
                    "admission queue", retry_after_ms=self.cfg.retry_after_ms)))
        # every answered request (drained, rejected) has its frame written
        # before the connections close; bounded, so a peer that stopped
        # reading cannot hold stop()
        pending = [t for t in self._dispatching if not t.done()]
        if pending:
            await asyncio.wait(pending, timeout=_STOP_GRACE_S)
        for w in list(self._writers):
            w.close()               # the transport flushes what was written
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), _STOP_GRACE_S)
            except asyncio.TimeoutError:      # pragma: no cover - stuck peer
                pass

    def __enter__(self) -> "SessionService":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- ingress -----------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._conn_seq += 1
        cid = self._conn_seq
        self._n_conns += 1
        self._writers.add(writer)
        if self._mx:
            self._mx.conns.set(float(self._n_conns))
        wlock = asyncio.Lock()
        decoder = FrameDecoder(self.cfg.max_frame)
        tasks: List[asyncio.Task] = []
        try:
            with self.obs.span("svc.conn", cat="service", conn=cid):
                try:
                    hello = await reader.readexactly(len(MAGIC))
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                if hello != MAGIC:
                    await self._write(writer, wlock, self._err_response(
                        {}, ProtocolError("bad connection magic")))
                    if self._mx:
                        self._mx.bad_frames.inc()
                    return
                async with wlock:
                    writer.write(MAGIC)
                    await writer.drain()
                while True:
                    data = await reader.read(1 << 16)
                    if not data:
                        if decoder.buffered and self._mx:
                            self._mx.truncated.inc()   # died mid-frame
                        return
                    try:
                        decoder.feed(data)
                        while True:
                            msg = decoder.next()
                            if msg is None:
                                break
                            t = asyncio.get_running_loop().create_task(
                                self._dispatch(msg[0], msg[1], writer, wlock))
                            self._dispatching.add(t)
                            t.add_done_callback(self._dispatching.discard)
                            tasks.append(t)
                            tasks = [x for x in tasks if not x.done()]
                    except ProtocolError as e:
                        if self._mx:
                            self._mx.bad_frames.inc()
                        await self._write(writer, wlock, self._err_response({}, e))
                        return        # no resync point after corruption
        except ConnectionError:       # client vanished; nothing to answer
            return
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
            self._n_conns -= 1
            self._writers.discard(writer)
            if self._mx:
                self._mx.conns.set(float(self._n_conns))
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):   # pragma: no cover
                pass

    async def _write(self, writer, wlock, resp) -> None:
        meta, payload = resp
        try:
            async with wlock:
                writer.write(encode_frame(meta, payload))
                await writer.drain()
        except (ConnectionError, OSError):
            pass      # the op already ran; the client just never hears

    def _tenant_of(self, meta: Dict[str, Any]) -> Optional[str]:
        if "tenant" in meta:
            return meta["tenant"]
        if "sid" in meta:
            try:
                return self._sid_tenant.get(int(meta["sid"]))
            except (TypeError, ValueError):
                return None
        return None

    def _rate_check(self, meta: Dict[str, Any]) -> float:
        """RETRY-AFTER ms if the tenant's bucket is empty, else 0."""
        if self.cfg.rate_limit is None:
            return 0.0
        tenant = self._tenant_of(meta)
        if tenant is None and meta.get("op") == "open_batch":
            tenants = meta.get("tenants") or []
            tenant = tenants[0] if tenants else None
        if tenant is None:
            return 0.0
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(
                self.cfg.rate_limit, self.cfg.rate_burst, self._clock)
        cost = (len(meta.get("tenants") or ())
                if meta.get("op") == "open_batch" else 1.0) or 1.0
        return b.take(cost)

    def _adopt(self, meta: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The request's trace context, or None when tracing is off.
        Adoption is total (``obs.trace.adopt_trace``): a missing ``trace``
        field or a fuzzer's garbage one degrades to a freshly minted trace
        id, never to a wire error."""
        if not self.obs.tracer.enabled:
            return None
        tr = adopt_trace(meta.get("trace"))
        tr["span_id"] = mint_span_id()      # the root span's own id
        return tr

    async def _dispatch(self, meta: Dict[str, Any], payload: bytes, writer, wlock) -> None:
        req = _Req(meta, payload, asyncio.get_running_loop().create_future(),
                   trace=self._adopt(meta), t0_ns=time.perf_counter_ns())
        op = meta.get("op")
        if op not in OPS:
            await self._finish(writer, wlock, req, self._err_response(
                meta, UnknownOpError(f"unknown op {op!r}; this service serves {OPS}")))
            return
        retry = self._rate_check(meta)
        if retry > 0.0:
            await self._finish(writer, wlock, req, self._err_response(
                meta, RateLimitedError(
                    f"tenant {self._tenant_of(meta)!r} is over its "
                    f"{self.cfg.rate_limit}/s rate limit", retry_after_ms=retry)))
            return
        if self._stopping or self._queue.qsize() >= self.cfg.max_pending:
            why = ("service shutting down" if self._stopping else
                   f"service request queue at max_pending={self.cfg.max_pending}")
            await self._finish(writer, wlock, req, self._err_response(
                meta, BackpressureError(why, retry_after_ms=self.cfg.retry_after_ms)))
            return
        if req.trace is not None:
            req.t_enq_ns = time.perf_counter_ns()
        await self._queue.put(req)
        try:
            resp = await req.fut
        except asyncio.CancelledError:
            return          # connection died; the op may still run
        await self._finish(writer, wlock, req, resp)

    async def _finish(self, writer, wlock, req: _Req, resp) -> None:
        meta = req.meta
        rmeta, rpayload = resp
        if req.trace is not None:
            # echo the adopted ids so the client can pair its half of the
            # timeline with the server's (old clients never look)
            rmeta = dict(rmeta, trace={"trace_id": req.trace["trace_id"],
                                       "span_id": req.trace["span_id"]})
            resp = (rmeta, rpayload)
        op = meta.get("op") or "_frame"
        code = err.EXC_BY_STATUS.get(rmeta.get("status", 0))
        if self._mx:
            self._mx.requests.inc(op=op, status=code.code if code else "OK")
            self._mx.request_ms.observe((time.perf_counter_ns() - req.t0_ns) / 1e6, op=op)
        t_w0 = time.perf_counter_ns()
        await self._write(writer, wlock, resp)
        t_w1 = time.perf_counter_ns()
        if self.skew is not None and op in ("open", "open_batch", "append", "query", "close"):
            self.skew.observe_request(self._tenant_of(meta), (t_w1 - req.t0_ns) / 1e6)
        if req.trace is not None:
            # the span tree is DEFERRED: the hot path pays one tuple
            # append; _build_request_spans assembles it at export time
            self.obs.tracer.defer(_build_request_spans, (
                req.trace, op, code.code if code else "OK",
                req.t0_ns, req.t_enq_ns, req.t_deq_ns,
                req.t_eng0_ns, req.t_eng1_ns, req.t_eng_tid,
                t_w0, t_w1, self._loop_tid,
                tuple(req.links) if req.links else None))

    # -- the single-writer worker -----------------------------------------

    async def _worker(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            item = await self._queue.get()
            batch = [item]
            while len(batch) < self.cfg.coalesce_max:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            stop = any(x is _STOP for x in batch)
            batch = [x for x in batch if x is not _STOP]
            if self._mx:
                self._mx.queue_depth.set(float(self._queue.qsize()))
                if batch:
                    self._mx.batch_ops.observe(float(len(batch)))
            if batch:
                now = time.perf_counter_ns()
                for r in batch:
                    if r.trace is not None:
                        r.t_deq_ns = now     # queue wait ends here
                done = await loop.run_in_executor(self._eng_exec, self._run_batch, batch)
                for fut, resp in done:
                    if not fut.done():
                        fut.set_result(resp)
            if stop:
                return

    def _err_response(self, meta: Dict[str, Any],
                      e: BaseException) -> Tuple[Dict[str, Any], bytes]:
        code = err.EXC_BY_STATUS.get(status_of(e))
        resp: Dict[str, Any] = {
            "id": meta.get("id"), "status": status_of(e),
            "code": code.code if code else "ERR_INTERNAL", "error": str(e)}
        if isinstance(e, err.RetryableError):
            resp["retry_after_ms"] = round(e.retry_after_ms, 3)
        return resp, b""

    def _ok(self, meta: Dict[str, Any], extra: Dict[str, Any],
            payload: bytes = b"") -> Tuple[Dict[str, Any], bytes]:
        out = {"id": meta.get("id"), "status": err.OK, "code": "OK"}
        out.update(extra)
        return out, payload

    def _shared_span(self, name: str, reqs: List[_Req], **attrs):
        """A span for engine work SHARED by several requests (coalesced
        flush, open storm): emitted ONCE with its own minted span id, which
        every rider's root span carries in ``links``.  Also stamps the
        riders' engine window.  Returns the span context."""
        traced = [r for r in reqs if r.trace is not None]
        if not traced:
            return self.obs.span(name, cat="service", **attrs)
        link = mint_span_id()
        now = time.perf_counter_ns()
        tid = threading.get_ident()
        for r in traced:
            r.links.append(link)
            if not r.t_eng0_ns:
                r.t_eng0_ns = now
                r.t_eng_tid = tid
        return self.obs.span(name, cat="service", span_id=link,
                             n_requests=len(reqs), **attrs)

    def _run_batch(self, batch: List[_Req]):
        """Engine-thread entry: apply one coalesced batch in arrival order
        under the engine's device, then let the admission controller hand
        freed slots to parked opens.  Returns [(future, response)] that the
        event loop resolves."""
        if self._cuda_device is None:
            return self._apply_batch(batch)
        with torch.cuda.device(self._cuda_device):
            return self._apply_batch(batch)

    def _apply_batch(self, batch: List[_Req]):
        out = []
        with self.obs.span("svc.batch", cat="service", n=len(batch)):
            # batched flush coalescing: >= 2 queries in one batch share a
            # single engine-wide forced flush; each query's own per-session
            # flush then only covers appends later in the batch (answers
            # are unchanged -- chunking invariance)
            qreqs: List[_Req] = []
            qsids = set()
            for r in batch:
                if r.meta.get("op") == "query":
                    s = self.engine.sessions.get(r.meta.get("sid"))
                    if s is not None and not s.closed and s.slot is not None:
                        qsids.add(int(r.meta["sid"]))
                        qreqs.append(r)
            if len(qsids) > 1:
                try:
                    with self._shared_span("svc.flush_shared", qreqs,
                                           n_sessions=len(qsids)):
                        self.engine.flush(force=tuple(sorted(qsids)))
                except Exception:       # per-request handling reports it
                    pass
            i = 0
            while i < len(batch):
                req = batch[i]
                meta = req.meta
                # contiguous FIFO-mode open runs coalesce into ONE admission
                # storm, sids in arrival order; a lone open stays plain
                if meta.get("op") == "open" and self.cfg.admission == "fifo":
                    j = i
                    while j < len(batch) and batch[j].meta.get("op") == "open":
                        j += 1
                    if j - i < 2:
                        out.extend(self._apply(req))
                        i += 1
                        continue
                    run = batch[i:j]
                    try:
                        with self._shared_span("svc.open_storm", run):
                            sids = self.engine.open_batch([r.meta.get("tenant") for r in run])
                        for r, sid in zip(run, sids):
                            self._sid_tenant[sid] = r.meta.get("tenant")
                            out.append((r.fut, self._ok(r.meta, {"sid": sid})))
                    except Exception as e:
                        for r in run:
                            out.append((r.fut, self._err_response(r.meta, e)))
                    finally:
                        now = time.perf_counter_ns()
                        for r in run:
                            if r.trace is not None:
                                r.t_eng1_ns = now
                    i = j
                    continue
                out.extend(self._apply(req))
                i += 1
            out.extend(self._admit_held())
            if self._mx:
                self._mx.admit_depth.set(float(len(self._held)))
            if self.skew is not None:
                self.skew.update_from_engine(self.engine)
        return out

    def _apply(self, req: _Req):
        """One request against the engine.  When tracing, it only STAMPS
        here (start/end and the engine thread's id); the ``svc.engine``
        span is materialized later onto this thread's track, so the
        ``engine.*`` spans the call emits nest inside it.  Returns
        [(future, response)] (empty while a scored open stays parked)."""
        if req.trace is None:
            return self._apply_op(req)
        if not req.t_eng0_ns:           # shared-flush riders keep theirs
            req.t_eng0_ns = time.perf_counter_ns()
        req.t_eng_tid = threading.get_ident()
        try:
            return self._apply_op(req)
        finally:
            req.t_eng1_ns = time.perf_counter_ns()

    def _apply_op(self, req: _Req):
        meta, payload, fut = req.meta, req.payload, req.fut
        op = meta.get("op")
        try:
            if op == "ping":
                return [(fut, self._ok(meta, {"pong": True}))]
            if op == "stats":
                return [(fut, self._ok(meta, {"stats": self._stats()}))]
            if op == "open":
                if self.cfg.admission == "fifo":
                    sid = self.engine.open(meta.get("tenant"))
                    self._sid_tenant[sid] = meta.get("tenant")
                    return [(fut, self._ok(meta, {"sid": sid}))]
                if not isinstance(meta.get("tenant"), str):
                    raise UnknownOpError(
                        f"open needs a string tenant, got {meta.get('tenant')!r}")
                if len(self._held) >= self.cfg.admit_queue_cap:
                    raise BackpressureError(
                        f"admission queue at admit_queue_cap={self.cfg.admit_queue_cap}",
                        retry_after_ms=self.cfg.retry_after_ms)
                self._held.append(req)
                return []           # resolved by _admit_held
            if op == "open_batch":
                tenants = meta.get("tenants") or []
                first = None
                if meta.get("first") is not None:
                    first, off = [], 0
                    for am in meta["first"]:
                        if am is None:
                            first.append(None)
                            continue
                        n = (np.dtype(am["dtype"]).itemsize
                             * int(np.prod([int(d) for d in am["shape"]], dtype=np.int64)))
                        first.append(_arr_from(am, payload[off:off + n]))
                        off += n
                sids = self.engine.open_batch(tenants, first=first)
                for sid, tenant in zip(sids, tenants):
                    self._sid_tenant[sid] = tenant
                return [(fut, self._ok(meta, {"sids": list(sids)}))]
            if op == "append":
                arr = _arr_from(meta.get("array") or {}, payload)
                self.engine.append(int(meta["sid"]), arr)
                return [(fut, self._ok(meta, {"n": int(len(arr))}))]
            if op == "query":
                got = self.engine.query(int(meta["sid"]), scope=meta.get("scope", "session"))
                a = np.asarray(got)
                return [(fut, self._ok(meta, {"array": _arr_meta(a)}, a.tobytes()))]
            if op == "close":
                merged, stats = self.engine.close(int(meta["sid"]))
                a = np.asarray(merged)
                return [(fut, self._ok(meta, {"array": _arr_meta(a), "session_stats": stats},
                                       a.tobytes()))]
            raise UnknownOpError(f"unknown op {op!r}")   # pragma: no cover
        except Exception as e:
            return [(fut, self._err_response(meta, e))]

    # -- Eq. 2 admission controller ---------------------------------------

    def _admit_held(self):
        """Hand free slots to parked opens by Eq. 2 score (engine thread).
        Never overfills: engine-queued sessions (the bulk ``open_batch``
        FIFO path) count against free capacity."""
        if not self._held:
            return []
        free = len(self.engine._free_slots) - len(self.engine._queue)
        if free <= 0:
            return []
        # the engine's view of tenant heat (slot held OR queued), the same
        # numbers the skew monitor's score spread reads
        occ_map, bl_map = self.engine.tenant_loads()
        tenants: List[str] = []
        tidx: Dict[str, int] = {}
        pend = []
        for req in self._held:
            t = req.meta["tenant"]
            if t not in tidx:
                tidx[t] = len(tenants)
                tenants.append(t)
            pend.append(tidx[t])
        order = scheduler.plan_admission(
            [bl_map.get(t, 0) for t in tenants],
            [occ_map.get(t, 0) for t in tenants], free, pend)
        out, taken = [], set(int(i) for i in order)
        winners = [self._held[int(i)] for i in order]
        try:
            if len(winners) >= 2:
                # a storm admitting together rides the batched lane-init
                # path, in the plan's order (capacity was checked, so none
                # of these queue in the engine)
                with self._shared_span("svc.admit_grant", winners):
                    sids = self.engine.open_batch([r.meta["tenant"] for r in winners])
            elif winners:
                with self._shared_span("svc.admit_grant", winners):
                    sids = [self.engine.open(winners[0].meta["tenant"])]
            else:
                sids = []
            for req, sid in zip(winners, sids):
                self._sid_tenant[sid] = req.meta["tenant"]
                out.append((req.fut, self._ok(req.meta, {"sid": sid})))
        except Exception as e:         # pragma: no cover - capacity raced
            for req in winners:
                out.append((req.fut, self._err_response(req.meta, e)))
        finally:
            now = time.perf_counter_ns()
            for req in winners:
                if req.trace is not None:
                    req.t_eng1_ns = now
        self._held = [h for j, h in enumerate(self._held) if j not in taken]
        return out

    def _stats(self) -> Dict[str, Any]:
        st = self.engine.stats_dict()
        return {
            "open_sessions": st["open_sessions"],
            "free_slots": st["free_slots"],
            "engine_queue": st["engine_queue"],
            "held_opens": len(self._held),
            "admission": self.cfg.admission,
            "totals": st["totals"],
        }

    def status(self) -> Dict[str, Any]:
        """The ``/statusz`` body: engine stats and service queue depths
        (and the skew monitor's summary when obs is on).  Read-only, host
        state only (no tensor, no CUDA call), callable from any thread --
        the scrape sidecar retries the rare mid-mutation dict race."""
        out: Dict[str, Any] = {
            "engine": self.engine.stats_dict(),
            "service": {
                "admission": self.cfg.admission,
                "held_opens": len(self._held),
                "request_queue": self._queue.qsize() if self._queue is not None else 0,
                "connections": self._n_conns,
                "address": list(self._addr) if self._addr else None,
            },
        }
        if self.skew is not None:
            out["skew"] = self.skew.summary()
        return out


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------

def _raise_for(meta: Dict[str, Any]) -> None:
    status = int(meta.get("status", err.ERR_INTERNAL))
    if status != err.OK:
        raise err.error_for_status(status, meta.get("error", "remote error"),
                                   meta.get("retry_after_ms"))


class ServiceClient:
    """Blocking wire client (tests, tooling): one request in flight at a
    time, taxonomy errors re-raised exactly as the engine raises them.

    ``trace=True`` (default) mints a fresh trace context per request and
    ships it in the header's ``trace`` field, so the server's root span
    carries client-visible ids (``last_trace`` after each call); servers
    that predate the field ignore it."""

    def __init__(self, host: str, port: int, *, timeout: float = 60.0,
                 max_frame: int = DEFAULT_MAX_FRAME, trace: bool = True):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._decoder = FrameDecoder(max_frame)
        self._seq = 0
        self._trace = bool(trace)
        #: the context minted for the most recent request (None before the
        #: first, or with ``trace=False``)
        self.last_trace: Optional[Dict[str, str]] = None
        self._sock.sendall(MAGIC)
        banner = self._recv_exact(len(MAGIC))
        if banner != MAGIC:
            raise ProtocolError(f"bad server banner {banner!r}")

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            got = self._sock.recv(n - len(buf))
            if not got:
                raise ConnectionError("server closed the connection")
            buf += got
        return buf

    def send_raw(self, data: bytes) -> None:
        """Escape hatch for the protocol-fuzz tests: ship raw bytes."""
        self._sock.sendall(data)

    def read_response(self) -> Tuple[Dict[str, Any], bytes]:
        """The next whole response frame (fuzz tests read rejections)."""
        while True:
            msg = self._decoder.next()
            if msg is not None:
                return msg
            got = self._sock.recv(1 << 16)
            if not got:
                raise ConnectionError("server closed the connection")
            self._decoder.feed(got)

    def request(self, meta: Dict[str, Any],
                payload: bytes = b"") -> Tuple[Dict[str, Any], bytes]:
        self._seq += 1
        meta = dict(meta, id=self._seq)
        if self._trace and "trace" not in meta:
            self.last_trace = meta["trace"] = new_trace_context()
        self._sock.sendall(encode_frame(meta, payload))
        rmeta, rpayload = self.read_response()
        _raise_for(rmeta)
        return rmeta, rpayload

    # -- ops
    def ping(self) -> bool:
        return bool(self.request({"op": "ping"})[0].get("pong"))

    def stats(self) -> Dict[str, Any]:
        return self.request({"op": "stats"})[0]["stats"]

    def open(self, tenant: str) -> int:
        return int(self.request({"op": "open", "tenant": tenant})[0]["sid"])

    def open_batch(self, tenants: List[str],
                   first: Optional[List[Optional[np.ndarray]]] = None) -> List[int]:
        meta: Dict[str, Any] = {"op": "open_batch", "tenants": list(tenants)}
        payload = b""
        if first is not None:
            metas: List[Optional[Dict[str, Any]]] = []
            for a in first:
                if a is None:
                    metas.append(None)
                else:
                    a = np.ascontiguousarray(a)
                    metas.append(_arr_meta(a))
                    payload += a.tobytes()
            meta["first"] = metas
        return [int(s) for s in self.request(meta, payload)[0]["sids"]]

    def append(self, sid: int, data: np.ndarray) -> int:
        a = np.ascontiguousarray(data)
        rmeta, _ = self.request({"op": "append", "sid": int(sid), "array": _arr_meta(a)},
                                a.tobytes())
        return int(rmeta["n"])

    def query(self, sid: int, scope: str = "session") -> np.ndarray:
        rmeta, payload = self.request({"op": "query", "sid": int(sid), "scope": scope})
        return _arr_from(rmeta["array"], payload)

    def close(self, sid: int) -> Tuple[np.ndarray, Dict[str, Any]]:
        rmeta, payload = self.request({"op": "close", "sid": int(sid)})
        return _arr_from(rmeta["array"], payload), rmeta["session_stats"]

    def close_conn(self) -> None:
        try:
            self._sock.close()
        except OSError:    # pragma: no cover
            pass

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close_conn()


class AsyncServiceClient:
    """Pipelining asyncio client (the open-loop load generator): many
    requests in flight per connection, responses matched by id.  As with
    ``ServiceClient``, ``trace=True`` mints a per-request trace context into
    the header's ``trace`` field."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 max_frame: int = DEFAULT_MAX_FRAME, trace: bool = True):
        self._reader, self._writer = reader, writer
        self._decoder = FrameDecoder(max_frame)
        self._seq = 0
        self._trace = bool(trace)
        self._pending: Dict[int, asyncio.Future] = {}
        self._pump: Optional[asyncio.Task] = None

    @classmethod
    async def connect(cls, host: str, port: int, max_frame: int = DEFAULT_MAX_FRAME, *,
                      trace: bool = True) -> "AsyncServiceClient":
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(MAGIC)
        await writer.drain()
        banner = await reader.readexactly(len(MAGIC))
        if banner != MAGIC:
            raise ProtocolError(f"bad server banner {banner!r}")
        self = cls(reader, writer, max_frame, trace=trace)
        self._pump = asyncio.get_running_loop().create_task(self._read_loop())
        return self

    async def _read_loop(self) -> None:
        try:
            while True:
                data = await self._reader.read(1 << 16)
                if not data:
                    raise ConnectionError("server closed the connection")
                self._decoder.feed(data)
                while True:
                    msg = self._decoder.next()
                    if msg is None:
                        break
                    rid = msg[0].get("id")
                    fut = self._pending.pop(rid, None)
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
        except (ConnectionError, ProtocolError, asyncio.CancelledError) as e:
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(e if not isinstance(e, asyncio.CancelledError)
                                      else ConnectionError("client closed"))
            self._pending.clear()

    async def request(self, meta: Dict[str, Any],
                      payload: bytes = b"") -> Tuple[Dict[str, Any], bytes]:
        self._seq += 1
        rid = self._seq
        meta = dict(meta, id=rid)
        if self._trace and "trace" not in meta:
            meta["trace"] = new_trace_context()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        self._writer.write(encode_frame(meta, payload))
        await self._writer.drain()
        rmeta, rpayload = await fut
        _raise_for(rmeta)
        return rmeta, rpayload

    # -- ops
    async def open(self, tenant: str) -> int:
        rmeta, _ = await self.request({"op": "open", "tenant": tenant})
        return int(rmeta["sid"])

    async def append(self, sid: int, data: np.ndarray) -> int:
        a = np.ascontiguousarray(data)
        rmeta, _ = await self.request(
            {"op": "append", "sid": int(sid), "array": _arr_meta(a)}, a.tobytes())
        return int(rmeta["n"])

    async def query(self, sid: int, scope: str = "session") -> np.ndarray:
        rmeta, payload = await self.request({"op": "query", "sid": int(sid), "scope": scope})
        return _arr_from(rmeta["array"], payload)

    async def close(self, sid: int) -> np.ndarray:
        rmeta, payload = await self.request({"op": "close", "sid": int(sid)})
        return _arr_from(rmeta["array"], payload)

    async def stats(self) -> Dict[str, Any]:
        rmeta, _ = await self.request({"op": "stats"})
        return rmeta["stats"]

    async def aclose(self) -> None:
        if self._pump is not None:
            self._pump.cancel()
        try:
            self._writer.close()
            await self._writer.wait_closed()
        except (ConnectionError, OSError):    # pragma: no cover
            pass
