"""Crash-restart smoke on PyTorch: SIGKILL a durable SessionEngine
mid-stream, recover it, and verify every answer against the uninterrupted
oracle (DESIGN.md §10, docs/durability.md).

    PYTHONPATH=src python examples/torch/crash_recovery.py [workdir] [--device cpu]

The script is its own harness: the parent re-runs this file with
``--child``, and the CHILD process drives a ``serve.DurableSessionEngine``
(Zipf-1.5 tenants, one deliberately hot so secondary-lane grants are
active, ragged appends, auto-checkpoint every 2 flushes) and then sends
itself SIGKILL at a fixed point PAST the last checkpoint -- a real
process death with un-checkpointed WAL tail on disk.  The parent then

  1. asserts the child actually died by SIGKILL,
  2. recovers the engine from the same directory
     (``SessionEngine.recover``) and asserts only the WAL *tail*
     replayed (replayed tuples < the full stream),
  3. asserts every open session's ``query()`` is bit-exact vs the numpy
     oracle over everything the child appended before dying,
  4. keeps streaming post-recovery and closes every session, again
     oracle-exact.

Multi-card: where more than one CUDA card is visible, both processes run
the engine with the slot lanes sharded over a ``lanes`` mesh of the cards
(8 lanes shard over 2, 4 or 8), so the recovery restores through the
lane-sharding path.
"""
import argparse
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.apps import histo
from repro_torch.core.distributed import make_mesh
from repro_torch.data.zipf import zipf_tuples
from repro_torch.serve import DurableSessionEngine, SessionEngine

PRE_ROUNDS, POST_ROUNDS, TENANTS = 3, 2, 6
NUM_PRI, NUM_SEC, CHUNK = 8, 2, 256
BINS, DOMAIN = 64, 1 << 16
PRIMARY_SLOTS, SECONDARY_SLOTS = 6, 2    # 8 lanes: shards over 1/2/4/8 cards
HOT = 0


def batch(r: int, t: int) -> np.ndarray:
    """The deterministic (round, tenant) append -- parent and child
    derive the identical stream from seeds alone."""
    n = (5 if t == HOT else 1) * CHUNK + (37 * r + 11 * t) % CHUNK + 1
    return zipf_tuples(n, DOMAIN, 1.5, seed=1000 * r + t)


def make_engine(dirpath: str, recovering: bool, device: str):
    cards = torch.cuda.device_count() if device.startswith("cuda") else 1
    mesh = (make_mesh(cards, "lanes", devices=[f"cuda:{i}" for i in range(cards)])
            if cards > 1 else None)
    spec = histo.make_spec(BINS, DOMAIN, NUM_PRI)
    if recovering:
        return spec, SessionEngine.recover(spec, dirpath, mesh=mesh, device=device)
    return spec, DurableSessionEngine(
        spec, directory=dirpath, num_pri=NUM_PRI, num_sec=NUM_SEC,
        chunk_size=CHUNK, primary_slots=PRIMARY_SLOTS,
        secondary_slots=SECONDARY_SLOTS, checkpoint_every=2, mesh=mesh,
        device=device)


def child(dirpath: str, device: str):
    _, eng = make_engine(dirpath, recovering=False, device=device)
    sids = {t: eng.open(f"t{t}") for t in range(TENANTS)}
    for r in range(PRE_ROUNDS):
        for t in sids:
            eng.append(sids[t], batch(r, t))
        eng.flush()          # auto-checkpoint fires at flush 2
    for t in sids:           # the un-checkpointed ragged tail
        eng.append(sids[t], batch(PRE_ROUNDS, t))
    eng._mgr.wait()          # the flush-2 checkpoint is fully on disk
    os.kill(os.getpid(), signal.SIGKILL)     # mid-stream, no cleanup


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        return child(args.workdir, args.device)

    workdir = args.workdir or tempfile.mkdtemp(prefix="crash_recovery_")
    # the child imports the package this process imported
    src = str(Path(sys.modules["repro_torch"].__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", workdir,
         "--device", args.device], env=env, timeout=560)
    assert r.returncode == -signal.SIGKILL, \
        f"child exited {r.returncode}, expected SIGKILL"
    print("OK child SIGKILLed mid-stream")

    spec, eng = make_engine(workdir, recovering=True, device=args.device)
    if eng.mesh is not None:
        print(f"recovering across {eng.num_lanes // eng.lanes_per_device} "
              f"cards x {eng.lanes_per_device} lanes")
    appended = {t: [batch(r, t) for r in range(PRE_ROUNDS + 1)]
                for t in range(TENANTS)}
    total = sum(len(b) for bs in appended.values() for b in bs)
    info = eng.recovery_info
    assert 0 < info["replayed_tuples"] < total, info
    print(f"OK WAL tail only: replayed {info['replayed_tuples']}/{total} "
          f"tuples ({info['replayed_records']} records past checkpoint "
          f"step {info['checkpoint_step']})")

    sids = {s.tenant: sid for sid, s in eng.sessions.items() if not s.closed}
    for t in range(TENANTS):
        keys = np.concatenate([b[:, 0] for b in appended[t]])
        np.testing.assert_array_equal(
            np.asarray(eng.query(sids[f"t{t}"])),
            histo.oracle(keys, BINS, DOMAIN, NUM_PRI))
    print(f"OK recovered answers oracle-exact ({TENANTS} sessions, "
          "Zipf 1.5, ragged appends)")

    for r in range(PRE_ROUNDS + 1, PRE_ROUNDS + 1 + POST_ROUNDS):
        for t in range(TENANTS):
            b = batch(r, t)
            eng.append(sids[f"t{t}"], b)
            appended[t].append(b)
        eng.flush()
    for t in range(TENANTS):
        keys = np.concatenate([b[:, 0] for b in appended[t]])
        merged, stats = eng.close(sids[f"t{t}"])
        np.testing.assert_array_equal(
            np.asarray(merged), histo.oracle(keys, BINS, DOMAIN, NUM_PRI))
        if t == HOT:
            assert stats["sec_lane_flushes"] > 0, \
                "hot tenant never used a granted secondary lane"
    print("OK post-recovery stream + close oracle-exact "
          f"({POST_ROUNDS} more rounds)")
    eng.shutdown()
    return info


if __name__ == "__main__":
    main()
