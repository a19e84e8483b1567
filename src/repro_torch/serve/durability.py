"""Session durability: a per-tenant write-ahead log, lane-state checkpoints
and crash-exact recovery for ``serve.SessionEngine``.

The counterpart of ``repro/serve/durability.py``, with its on-disk formats:

  WAL         every ``open``/``append``/``close`` is logged -- per tenant,
              append-only, CRC-framed -- so every session's input stream
              can be rebuilt from disk.  The file format is the JAX
              package's byte for byte: the magic ``DWAL\\x01\\x00\\x00\\x00``,
              frames of ``<II`` (body length, crc32) and a ``<I`` JSON head
              length, compact JSON with one engine-wide ``seq``, one file
              per tenant named ``slug-sha1[:8].wal``, watermark (``wm``)
              records in every file, torn tails truncated on reopen.
  checkpoint  periodically every lane of the lanes-stacked ``ExecState`` is
              gathered from the engine's shards, taken to the host and
              saved through
              ``checkpoint.CheckpointManager`` (async, atomic, keep-k) with
              the scheduler metadata (slot map, grants, queue, backlogs,
              stats) and the WAL seq it covers (the flush watermark).  The
              layout is the JAX package's and knows no mesh: either
              package restores the other's checkpoints, and a local
              engine's restore onto a meshed one and back (the lanes are
              split over the shards on restore).

Recovery (``recover``) restores the newest readable checkpoint and replays
only the WAL tail past its watermark.

Flush markers (the port's one deliberate divergence from the JAX log).
Besides the data records the port logs where the engine's own flushes ran:
``{"t": "admit", "sids": [...]}`` after an ``open_batch``'s opens and first
appends (the storm's admission flush), ``{"t": "flush", "force": [...]}``
after an engine-wide flush, and ``{"t": "fsess", "sid": n}`` after a
per-session flush that is not part of a close.  Replay runs the same
flushes at the same points, so a recovered engine's backlogs, flush count,
slot table, grants and lane states equal those of a run that never
crashed.  The JAX package logs none of these and replays its appends into
the backlogs without the flushes that drained them: its answers stay exact
(flush timing never changes them), but its recovered backlogs and flush
count do not (ROADMAP §3).  Its replay skips a record type it does not
know, so a directory the port wrote still recovers there, answers equal.

Failure model.  The process can die at any instruction.  Durable truth is
``<dir>/wal/*.wal``, ``<dir>/ckpt/step_N/`` and ``<dir>/config.json``.  A
torn WAL tail is cut back on reopen; a torn checkpoint is invisible (atomic
rename) or skipped by ``CheckpointManager.restore``.  With
``wal_sync=False`` (default) a record survives process death once
``append()`` returns; machine death needs ``wal_sync=True``.  ``close()``
is logged after it succeeds, so a crash inside it recovers the session
still open with its data intact.

SIGTERM is not a crash: with a ``train.ft.PreemptionGuard`` the engine
drains instead -- flush every admitted session, blocking checkpoint,
release the WAL -- and then raises ``EnginePreempted`` on new work.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import re
import shutil
import struct
import time
import zlib
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.core import compilemon
from repro_torch.core import executor as core_executor
from repro_torch.serve.errors import EnginePreempted
from repro_torch.serve.session import SessionEngine, SessionStats, _Session

_WAL_MAGIC = b"DWAL\x01\x00\x00\x00"      # 8-byte file header: magic + v1
_FRAME = struct.Struct("<II")             # body length, crc32(body)
_HEAD = struct.Struct("<I")               # json header length


# ---------------------------------------------------------------------------
# Write-ahead log
# ---------------------------------------------------------------------------

def _encode_record(meta: Dict[str, Any], payload: bytes = b"") -> bytes:
    head = json.dumps(meta, separators=(",", ":")).encode()
    body = _HEAD.pack(len(head)) + head + payload
    return _FRAME.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF) + body


def _read_wal_file(path: Path) -> Tuple[List[Tuple[dict, bytes]], int]:
    """Parse one WAL file tolerantly: ``(records, valid_end)``, where
    ``valid_end`` is the byte offset past the last intact frame (a torn
    tail -- a short frame or a CRC mismatch -- ends the file there).  A
    file without the magic header parses as empty."""
    records: List[Tuple[dict, bytes]] = []
    raw = path.read_bytes()
    if len(raw) < len(_WAL_MAGIC) or raw[:len(_WAL_MAGIC)] != _WAL_MAGIC:
        return records, 0
    off = len(_WAL_MAGIC)
    while True:
        if off + _FRAME.size > len(raw):
            break
        length, crc = _FRAME.unpack_from(raw, off)
        body = raw[off + _FRAME.size:off + _FRAME.size + length]
        if len(body) < length or (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            break
        try:
            hlen, = _HEAD.unpack_from(body, 0)
            meta = json.loads(body[_HEAD.size:_HEAD.size + hlen])
            payload = body[_HEAD.size + hlen:]
        except (struct.error, ValueError):
            break
        records.append((meta, payload))
        off += _FRAME.size + length
    return records, off


class WriteAheadLog:
    """Per-tenant, append-only, CRC-framed write-ahead log.

    One ``.wal`` file per tenant (sanitized name plus a hash of it, so any
    tenant string maps to a unique stable file name).  A record is a
    length+CRC frame holding a compact JSON header (type, engine-wide
    ``seq``, sid, array dtype and shape) and the raw payload bytes; replay
    merges the files back into the total order by ``seq``.  Watermark
    records (``{"t": "wm", "step": N, "upto": seq}``) go into every tenant
    file when a checkpoint is taken: they mark the prefix it covers and
    bound ``gc()``.

    Opening a directory cuts every file back to its last intact frame.
    ``sync=True`` fsyncs every record; the default flushes to the OS.
    ``obs=`` instruments the log (``wal.append`` spans,
    ``wal_records_total{type}``, ``wal_bytes_total``, ``wal_append_ms``,
    ``wal_fsync_ms``); ``obs=None`` leaves it uninstrumented.
    """

    def __init__(self, directory: os.PathLike, *, sync: bool = False, obs=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.sync = sync
        self.obs = obs
        if obs is not None:
            reg = obs.registry
            self._m_records = reg.counter(
                "wal_records_total", "WAL records appended, by record type",
                labels=("type",))
            self._m_bytes = reg.counter("wal_bytes_total",
                                        "framed bytes appended to the WAL")
            self._m_append = reg.histogram("wal_append_ms",
                                           "wall-clock per WAL record append")
            self._m_fsync = reg.histogram("wal_fsync_ms",
                                          "wall-clock per WAL fsync (sync=True)")
        self._files: Dict[Path, Any] = {}     # path -> open append handle
        self.seq = 1
        for p in sorted(self.dir.glob("*.wal")):
            recs, valid_end = _read_wal_file(p)
            if valid_end < p.stat().st_size:
                # a torn tail: cut back to the last intact frame (a torn
                # header cuts to empty, and the next append rewrites it)
                with open(p, "rb+") as f:
                    f.truncate(valid_end)
            for meta, _ in recs:
                self.seq = max(self.seq, int(meta["seq"]) + 1)

    def _tenant_path(self, tenant: str) -> Path:
        slug = re.sub(r"[^A-Za-z0-9_.-]", "_", tenant)[:40] or "t"
        digest = hashlib.sha1(tenant.encode()).hexdigest()[:8]
        return self.dir / f"{slug}-{digest}.wal"

    def _handle(self, path: Path):
        f = self._files.get(path)
        if f is None:
            fresh = not path.exists() or path.stat().st_size == 0
            f = open(path, "ab")
            if fresh:
                f.write(_WAL_MAGIC)
            self._files[path] = f
        return f

    def _write(self, f, frame: bytes):
        f.write(frame)
        f.flush()
        if self.sync:
            if self.obs is not None and self.obs.enabled:
                t0 = time.perf_counter()
                os.fsync(f.fileno())
                self._m_fsync.observe((time.perf_counter() - t0) * 1e3)
            else:
                os.fsync(f.fileno())

    def log(self, tenant: str, meta: Dict[str, Any], payload: bytes = b"") -> int:
        """Append one record to ``tenant``'s log; returns its seq."""
        meta = dict(meta, seq=self.seq)
        self.seq += 1
        frame = _encode_record(meta, payload)
        f = self._handle(self._tenant_path(tenant))
        if self.obs is not None and self.obs.enabled:
            t0 = time.perf_counter()
            with self.obs.span("wal.append", cat="wal", type=str(meta.get("t")),
                               n_bytes=len(frame)):
                self._write(f, frame)
            self._m_append.observe((time.perf_counter() - t0) * 1e3)
            self._m_records.inc(type=str(meta.get("t")))
            self._m_bytes.inc(len(frame))
        else:
            self._write(f, frame)
        return meta["seq"]

    def watermark(self, step: int, upto: int) -> None:
        """Record "checkpoint ``step`` covers every record with ``seq <=
        upto``" in every tenant file (one shared seq)."""
        meta = {"t": "wm", "step": step, "upto": upto, "seq": self.seq}
        self.seq += 1
        frame = _encode_record(meta)
        for p in sorted(self.dir.glob("*.wal")):
            self._write(self._handle(p), frame)

    def replay(self, after_seq: int = 0) -> List[Tuple[dict, bytes]]:
        """Every non-watermark record with ``seq > after_seq``, in seq order."""
        recs: List[Tuple[dict, bytes]] = []
        for p in sorted(self.dir.glob("*.wal")):
            recs.extend(r for r in _read_wal_file(p)[0]
                        if r[0]["t"] != "wm" and r[0]["seq"] > after_seq)
        recs.sort(key=lambda r: r[0]["seq"])
        return recs

    def watermarks(self) -> Dict[int, int]:
        """``{checkpoint step: covered seq}`` from the watermark records."""
        out: Dict[int, int] = {}
        for p in sorted(self.dir.glob("*.wal")):
            for meta, _ in _read_wal_file(p)[0]:
                if meta["t"] == "wm":
                    out[meta["step"]] = max(out.get(meta["step"], 0), meta["upto"])
        return out

    def gc(self, upto: int) -> None:
        """Drop records with ``seq <= upto`` (pass the watermark of the
        oldest kept checkpoint).  Each file is rewritten to a temp and
        renamed atomically."""
        for p in sorted(self.dir.glob("*.wal")):
            recs, _ = _read_wal_file(p)
            keep = [r for r in recs if r[0]["seq"] > upto]
            if len(keep) == len(recs):
                continue
            f = self._files.pop(p, None)
            if f is not None:
                f.close()
            tmp = p.with_name(p.name + ".tmp")
            with open(tmp, "wb") as g:
                g.write(_WAL_MAGIC)
                for meta, payload in keep:
                    g.write(_encode_record(meta, payload))
                g.flush()
                os.fsync(g.fileno())
            os.replace(tmp, p)

    def close(self) -> None:
        for f in self._files.values():
            f.flush()
            f.close()
        self._files = {}


# ---------------------------------------------------------------------------
# Durable engine
# ---------------------------------------------------------------------------

_CONFIG_NAME = "config.json"
_TELEMETRY_KEEP = 256    # per-flush telemetry rows carried per checkpoint
# SessionEngine keywords that round-trip through config.json (JSON scalars;
# the JAX package's list less kernel_backend: the device is the caller's)
_CFG_ENGINE_KW = ("lanes_axis", "profile_chunks", "threshold", "mem_width_tuples",
                  "static_plan", "aot_buckets", "telemetry_cap")
_ENGINE_FILE = "engine"    # the WAL file of markers that name no session


class DurableSessionEngine(SessionEngine):
    """A ``SessionEngine`` whose sessions survive the process.

    Args (beside every ``SessionEngine`` keyword):
      directory: the durability root; holds ``wal/``, ``ckpt/`` and
        ``config.json``.  A fresh engine refuses a directory that holds
        durable state (``recover()`` resumes it; ``overwrite=True``
        discards it).
      checkpoint_every: take an async checkpoint after this many
        engine-wide flushes (0: only explicit ``checkpoint()`` calls).
      keep: checkpoints kept.
      wal_sync: fsync every WAL record.
      guard: an optional ``train.ft.PreemptionGuard``; once it fires, the
        next ``open``/``append``/``close``/``flush`` drains the engine and
        raises ``EnginePreempted``.  ``query()`` stays available after.

    After a recovery ``recovery_info`` holds ``{checkpoint_step,
    wal_watermark, replayed_records, replayed_tuples, replay_anomalies}``.
    """

    def __init__(self, spec, *, directory: os.PathLike,
                 checkpoint_every: int = 4, keep: int = 3,
                 wal_sync: bool = False, guard=None,
                 overwrite: bool = False, _recovering: bool = False, **kw):
        engine_kw = {k: kw[k] for k in _CFG_ENGINE_KW if k in kw}
        super().__init__(spec, **kw)
        if self._aot_widths:
            # the max width, an int, so that the knob round-trips through
            # config.json and recover() lands in the same bucket table
            engine_kw["aot_buckets"] = int(self._aot_widths[-1])
        self.dir = Path(directory)
        wal_dir, ckpt_dir = self.dir / "wal", self.dir / "ckpt"
        if not _recovering:
            stale = any(wal_dir.glob("*.wal")) or any(ckpt_dir.glob("step_*"))
            if stale and not overwrite:
                raise ValueError(
                    f"{self.dir} already holds durable session state; "
                    "resume it with SessionEngine.recover(...) or pass "
                    "overwrite=True to discard it")
            if stale:
                shutil.rmtree(wal_dir, ignore_errors=True)
                shutil.rmtree(ckpt_dir, ignore_errors=True)
        self._wal = WriteAheadLog(wal_dir, sync=wal_sync, obs=self.obs)
        self._mgr = CheckpointManager(ckpt_dir, keep=keep)
        reg = self.obs.registry
        self._dx_ckpts = reg.counter("checkpoints_total", "checkpoints taken")
        self._dx_ckpt_ms = reg.histogram(
            "checkpoint_save_ms", "host-side checkpoint capture + "
            "enqueue wall-clock (async write excluded unless block=True)")
        self._dx_step = reg.gauge("checkpoint_step", "latest checkpoint step taken")
        self._dx_replayed = reg.counter("recovery_replay_records_total",
                                        "WAL tail records replayed during recovery")
        self._dx_replayed_tuples = reg.counter(
            "recovery_replay_tuples_total",
            "tuples re-appended from the WAL tail during recovery")
        self.checkpoint_every = max(0, int(checkpoint_every))
        self._guard = guard
        self.drained = False
        self._replaying = False
        self._closing = False
        self.recovery_info: Optional[Dict[str, Any]] = None
        self._ckpt_step = (self._mgr.latest_step() or 0) + 1
        self._flushes_since_ckpt = 0
        self._wm_seq_by_step: Dict[int, int] = {}
        if not _recovering:
            self._write_config(wal_sync, engine_kw)

    # ---------------------------------------------------------------- config
    def _write_config(self, wal_sync: bool, engine_kw: Dict[str, Any]):
        cfg = {
            "version": 1,
            "app": self.spec.name,
            "num_pri": self.num_pri, "num_sec": self.num_sec,
            "chunk_size": self.chunk_size,
            "primary_slots": self.primary_slots,
            "secondary_slots": self.secondary_slots,
            "min_grant_chunks": self.min_grant_chunks,
            "checkpoint_every": self.checkpoint_every,
            "keep": self._mgr.keep,
            "wal_sync": wal_sync,
            "engine_kw": {k: v for k, v in engine_kw.items()
                          if isinstance(v, (str, int, float, bool, type(None)))},
        }
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = self.dir / (_CONFIG_NAME + ".tmp")
        tmp.write_text(json.dumps(cfg, indent=2))
        os.replace(tmp, self.dir / _CONFIG_NAME)

    def _logging(self) -> bool:
        return not self._replaying and not self.drained

    # ------------------------------------------------------------- lifecycle
    def open(self, tenant: str = "default") -> int:
        self._preempt_check()
        if not self._replaying:
            self._wal.log(tenant, {"t": "open", "sid": self._next_sid, "tenant": tenant})
        return super().open(tenant)

    def append(self, sid: int, data: np.ndarray) -> None:
        self._preempt_check()
        arr = np.asarray(data)
        if not self._replaying:
            tenant = self._session(sid).tenant   # bad sids never hit the log
            self._wal.log(tenant, {"t": "app", "sid": sid, "dtype": str(arr.dtype),
                                   "shape": list(arr.shape)}, arr.tobytes())
        super().append(sid, arr)

    def close(self, sid: int):
        self._preempt_check()
        self._closing = True        # its own flush replays with the close
        try:
            out = super().close(sid)
        finally:
            self._closing = False
        if not self._replaying:
            # logged after success: a close that raised must not replay; a
            # crash between the close and this record recovers the session
            # still open, its data intact
            self._wal.log(self.sessions[sid].tenant, {"t": "close", "sid": sid})
        return out

    def _admit_storm(self, sids, sp, snap, t0) -> None:
        if self._logging():
            owner = next((sid for sid in sids if self.sessions[sid].slot is not None),
                         sids[0] if sids else None)
            self._wal.log(_ENGINE_FILE if owner is None else self.sessions[owner].tenant,
                          {"t": "admit", "sids": [int(s) for s in sids]})
        super()._admit_storm(sids, sp, snap, t0)

    def flush(self, force=()) -> None:
        if self.drained:
            # the read path of a drained engine: query(scope="engine") comes
            # here, and a post-drain flush only moves backlog the drain
            # checkpoint captured -- no WAL, no checkpoint
            SessionEngine.flush(self, force)
            return
        self._preempt_check()
        force = sorted(int(s) for s in force)
        super().flush(force)
        if not self._replaying:
            owner = self.sessions[force[0]].tenant if force else _ENGINE_FILE
            self._wal.log(owner, {"t": "flush", "force": force})
            if self.checkpoint_every:
                self._flushes_since_ckpt += 1
                if self._flushes_since_ckpt >= self.checkpoint_every:
                    self.checkpoint()

    def flush_session(self, sid: int) -> None:
        super().flush_session(sid)
        if self._logging() and not self._closing:
            self._wal.log(self.sessions[sid].tenant, {"t": "fsess", "sid": int(sid)})

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self, block: bool = False) -> int:
        """Persist a consistent cut of the engine: every lane of the
        lanes-stacked ``ExecState`` (gathered from the shards, copied to the
        host before this returns), the scheduler and session metadata, and the
        WAL seq it covers.  The write runs async unless ``block``.  Every
        checkpoint then drops the WAL records the oldest kept one covers."""
        t0 = time.perf_counter()
        with self.obs.span("ckpt.save", cat="ckpt", block=bool(block)) as sp:
            upto = self._wal.seq - 1    # every record logged so far
            lanes = self._lanes.gather_states(self._states)
            step = self._ckpt_step
            self._ckpt_step += 1
            meta = self._capture_meta(upto, step)
            blob = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
            self._mgr.save(step, {"lanes": lanes, "meta": blob}, block=block)
            self._wal.watermark(step, upto)
            sp.set(step=step, wal_upto=upto)
        self._wm_seq_by_step[step] = upto
        self._flushes_since_ckpt = 0
        self._gc_wal()
        self._dx_ckpts.inc()
        self._dx_step.set(step)
        self._dx_ckpt_ms.observe((time.perf_counter() - t0) * 1e3)
        return step

    def _gc_wal(self) -> None:
        """Drop WAL records the oldest kept checkpoint covers (its
        watermark from this process, else from the WAL's own watermark
        records, so GC resumes after a recovery)."""
        steps = self._mgr.steps()
        if not steps:
            return
        upto = self._wm_seq_by_step.get(steps[0])
        if upto is None:
            upto = self._wal.watermarks().get(steps[0])
        if upto is not None:
            self._wal.gc(upto)

    def _capture_meta(self, wal_seq: int, step: int) -> Dict[str, Any]:
        sessions = {}
        for sid, s in self.sessions.items():
            ent: Dict[str, Any] = {"tenant": s.tenant, "slot": s.slot,
                                   "closed": s.closed, "stats": s.stats.as_dict()}
            if s.backlog_tuples:
                pend = s.pending_arrays()
                b = pend[0] if len(pend) == 1 else np.concatenate(pend, axis=0)
                ent["backlog"] = {
                    "dtype": str(b.dtype), "shape": list(b.shape),
                    "data": base64.b64encode(b.tobytes()).decode("ascii")}
            sessions[str(sid)] = ent
        return {
            "version": 1, "step": step, "wal_seq": wal_seq,
            "next_sid": self._next_sid, "flush_no": self._flush_no,
            "slot_reschedules": self._slot_reschedules,
            "slot_sid": [-1 if x is None else int(x) for x in self._slot_sid],
            "sec_assign": [int(x) for x in self._sec_assign],
            "queue": list(self._queue),
            "feat_shape": (list(self._feat_shape)
                           if self._feat_shape is not None else None),
            "dtype": (str(np.dtype(self._dtype)) if self._dtype is not None else None),
            # a bounded tail of the telemetry ring: observability, not state
            "telemetry": list(self._telemetry)[-_TELEMETRY_KEEP:],
            "sessions": sessions,
        }

    def _restore_meta(self, meta: Dict[str, Any]) -> None:
        self._next_sid = int(meta["next_sid"])
        self._flush_no = int(meta["flush_no"])
        self._slot_reschedules = int(meta["slot_reschedules"])
        self._slot_sid = [None if x < 0 else int(x) for x in meta["slot_sid"]]
        # a sorted list is a valid min-heap, mirroring the restored slot map
        self._free_slots = sorted(i for i, x in enumerate(self._slot_sid) if x is None)
        self._sec_assign = np.asarray(meta["sec_assign"], np.int64)
        self._queue = deque(int(x) for x in meta["queue"])
        self._feat_shape = (tuple(meta["feat_shape"])
                            if meta["feat_shape"] is not None else None)
        self._dtype = np.dtype(meta["dtype"]) if meta["dtype"] else None
        # the telemetry ring with this engine's cap; its accounting restarts
        self._telemetry = deque(meta["telemetry"], maxlen=self.telemetry_cap)
        self._telemetry_total = len(self._telemetry)
        self._telemetry_dropped = 0
        self._rows_validated = 0
        self.sessions = {}
        for sid_s, ent in meta["sessions"].items():
            backlog, n = deque(), 0
            if "backlog" in ent:
                b = ent["backlog"]
                arr = np.frombuffer(base64.b64decode(b["data"]), dtype=np.dtype(b["dtype"]))
                arr = arr.reshape(b["shape"])
                backlog, n = deque([arr]), len(arr)
            self.sessions[int(sid_s)] = _Session(
                int(sid_s), ent["tenant"], slot=ent["slot"], backlog=backlog,
                backlog_tuples=n, stats=SessionStats(**ent["stats"]),
                closed=ent["closed"])

    # -------------------------------------------------------------- recovery
    def _recover(self) -> None:
        with self.obs.span("recover", cat="recover") as rsp:
            with self.obs.span("ckpt.restore", cat="recover"):
                template = {"lanes": core_executor.stack_states(self._res.init_state(),
                                                                self.num_lanes),
                            "meta": np.zeros(0, np.uint8)}
                try:
                    ck = self._mgr.restore(template, device=self.device)
                except RuntimeError as e:
                    # checkpoints exist but none restored: a WAL-only
                    # recovery would be wrong wherever GC dropped records
                    # they cover, so refuse instead of answering short
                    raise RuntimeError(
                        f"{self.dir}: no checkpoint restored cleanly; "
                        "refusing WAL-only recovery (the WAL may have "
                        "been GC'd past their watermarks).  Repair or "
                        "remove ckpt/, or recover with the original "
                        "engine shape.") from e
                wal_seq, ck_step = 0, None
                if ck is not None:
                    meta = json.loads(ck["meta"].cpu().numpy().tobytes().decode())
                    self._restore_meta(meta)
                    wal_seq = int(meta["wal_seq"])
                    ck_step = int(meta["step"])
                    self._states = self._lanes.shard_states(ck["lanes"])
            if self._aot_widths and self._dtype is not None:
                # land in the same buckets before the tail replays
                with self.obs.span("recover.warmup", cat="recover"):
                    self.warmup()
            recs = self._wal.replay(after_seq=wal_seq)
            replayed_tuples, anomalies = 0, 0
            self._replaying = True
            try:
                with self.obs.span("recover.replay", cat="recover", records=len(recs)):
                    for meta_r, payload in recs:
                        try:
                            replayed_tuples += self._replay_record(meta_r, payload)
                        except (ValueError, KeyError):
                            anomalies += 1   # the original call failed alike
            finally:
                self._replaying = False
            rsp.set(checkpoint_step=ck_step, wal_watermark=wal_seq,
                    replayed_records=len(recs))
        self._dx_replayed.inc(len(recs))
        self._dx_replayed_tuples.inc(replayed_tuples)
        self.recovery_info = {
            "checkpoint_step": ck_step,
            "wal_watermark": wal_seq,
            "replayed_records": len(recs),
            "replayed_tuples": int(replayed_tuples),
            "replay_anomalies": anomalies,
        }

    def _replay_record(self, meta: Dict[str, Any], payload: bytes) -> int:
        """Re-run one logged operation; returns the tuples it re-appended."""
        t = meta["t"]
        if t == "open":
            got = self.open(meta["tenant"])
            if got != meta["sid"]:
                raise RuntimeError(f"replayed open produced sid {got}, WAL says "
                                   f"{meta['sid']}: the WAL and checkpoint disagree")
        elif t == "app":
            arr = np.frombuffer(payload, dtype=np.dtype(meta["dtype"]))
            self.append(meta["sid"], arr.reshape(meta["shape"]))
            return int(meta["shape"][0]) if meta["shape"] else 0
        elif t == "close":
            self.close(meta["sid"])
        elif t == "admit":
            sids = [int(s) for s in meta["sids"]]
            with self.obs.span("engine.admit_storm", cat="admit",
                               n_tenants=len(sids)) as sp:
                self._admit_storm(sids, sp, compilemon.snapshot(), time.perf_counter())
        elif t == "flush":
            self.flush(meta["force"])
        elif t == "fsess":
            self.flush_session(meta["sid"])
        return 0

    # ------------------------------------------------------------ preemption
    def _preempt_check(self) -> None:
        if self._replaying:
            return
        if self.drained:
            raise EnginePreempted(
                "engine drained after preemption; recover() resumes the "
                f"sessions from {self.dir}")
        if self._guard is not None and self._guard.preempted:
            self.drain()
            raise EnginePreempted(
                "preemption signal: open sessions flushed and "
                f"checkpointed under {self.dir}; recover() resumes them")

    def drain(self) -> None:
        """The graceful SIGTERM path: flush every admitted session's backlog,
        take a blocking checkpoint (ragged remainders ride its backlog
        metadata), release the WAL and the guard's signal handlers.
        Idempotent; afterwards new work raises ``EnginePreempted`` while
        ``query()`` still answers."""
        if self.drained:
            return
        with self.obs.span("engine.drain", cat="ckpt"):
            SessionEngine.flush(self)   # bypass the checkpoint-every hook
            self.checkpoint(block=True)
            self._wal.close()
            if self._guard is not None:
                self._guard.uninstall()
            self.drained = True

    def shutdown(self) -> None:
        """Release the checkpoint thread and WAL handles without draining
        (the teardown path)."""
        self._mgr.close()
        self._wal.close()


def recover(spec, directory: os.PathLike, *, mesh=None, device="cuda", guard=None,
            **overrides) -> DurableSessionEngine:
    """Resume a durable engine from ``directory``: rebuild it from
    ``config.json`` (``overrides`` win over saved knobs; ``spec`` must be
    the application the directory served; a ``kernel_backend`` that the
    JAX package wrote is ignored), restore the newest readable checkpoint
    onto the shards of ``mesh`` (a ``core.distributed.Mesh`` with a
    ``lanes`` axis, whatever mesh wrote the directory) or, without one,
    onto ``device``, and replay the WAL tail past its watermark."""
    directory = Path(directory)
    cfg = json.loads((directory / _CONFIG_NAME).read_text())
    if cfg.get("app") not in (None, spec.name):
        raise ValueError(f"{directory} was serving app {cfg['app']!r}, "
                         f"got spec {spec.name!r}")
    engine_kw = {k: v for k, v in cfg.get("engine_kw", {}).items()
                 if k != "kernel_backend"}
    kw: Dict[str, Any] = dict(
        num_pri=cfg["num_pri"], num_sec=cfg["num_sec"], chunk_size=cfg["chunk_size"],
        primary_slots=cfg["primary_slots"], secondary_slots=cfg["secondary_slots"],
        min_grant_chunks=cfg["min_grant_chunks"], **engine_kw)
    ctl = {k: overrides.pop(k, cfg[k]) for k in ("checkpoint_every", "keep", "wal_sync")}
    kw.update(overrides)
    eng = DurableSessionEngine(spec, directory=directory, mesh=mesh, device=device,
                               guard=guard, _recovering=True, **ctl, **kw)
    eng._recover()
    return eng
