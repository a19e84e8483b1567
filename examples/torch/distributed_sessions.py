"""Distributed session serving on PyTorch: slot lanes sharded across a mesh.

One `serve.SessionEngine(mesh=...)` serves MORE tenants than a single
shard's lane budget: the lanes axis is split over a ``lanes`` mesh of 8
shards (all on one card by default, or on the CPU;
`core.distributed.make_lane_sharded_executor`, DESIGN.md §9), every shard
advances its local lanes in one batched step, and a secondary-lane
re-grant whose old owner lives on a different shard runs the paper's
§IV-B shadow-buffer merge across shards.

The script drives Zipf-1.5 tenants with ragged appends (one
deliberately hot so grants actually move), interleaves engine-wide
flushes with per-session-flush queries, and asserts every answer
bit-exact against BOTH the numpy oracle and an identically-driven
unsharded engine -- then prints the telemetry headlines.

    PYTHONPATH=src python examples/torch/distributed_sessions.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.apps import histo
from repro_torch.core.distributed import make_mesh
from repro_torch.data.zipf import zipf_tuples
from repro_torch.serve import SessionEngine

NUM_PRI, NUM_SEC, CHUNK = 8, 2, 256
BINS, DOMAIN = 64, 1 << 16
PRIMARY_SLOTS, SECONDARY_SLOTS = 12, 4      # 16 lanes
HOT, ROUNDS = 0, 3
SHARDS = 8


def drive(eng):
    """Identical multi-tenant scenario for any engine; returns every
    query/close answer so two engines can be compared bit-for-bit."""
    rng = np.random.default_rng(7)
    sids = {t: eng.open(tenant=f"t{t}") for t in range(PRIMARY_SLOTS)}
    appended = {t: [] for t in sids}
    answers = {}
    for r in range(ROUNDS):
        for t in sids:
            n = (6 if t == HOT else 1) * CHUNK + int(rng.integers(1, CHUNK))
            batch = zipf_tuples(n, DOMAIN, 1.5, seed=100 * r + t)
            eng.append(sids[t], batch)
            appended[t].append(batch)
        eng.flush()                      # engine-wide: grants may move
        for t in (HOT, 1 + r % (PRIMARY_SLOTS - 1)):
            answers[f"q{r}.{t}"] = eng.query(sids[t])   # per-session flush
    for t in sids:
        merged, _ = eng.close(sids[t])
        answers[f"c{t}"] = merged
    keys = {t: np.concatenate([b[:, 0] for b in appended[t]])
            for t in appended}
    return answers, keys, eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = make_mesh(SHARDS, "lanes", device=args.device)
    lanes_per_shard = (PRIMARY_SLOTS + SECONDARY_SLOTS) // SHARDS
    print(f"{SHARDS} shards, {PRIMARY_SLOTS}P+{SECONDARY_SLOTS}S lanes "
          f"({lanes_per_shard}/shard), {PRIMARY_SLOTS} concurrent sessions")
    assert PRIMARY_SLOTS > lanes_per_shard, \
        "the point: more sessions than one shard's lane budget"
    spec = histo.make_spec(BINS, DOMAIN, NUM_PRI)

    def engine(mesh_arg):
        return SessionEngine(spec, num_pri=NUM_PRI, num_sec=NUM_SEC,
                             chunk_size=CHUNK, primary_slots=PRIMARY_SLOTS,
                             secondary_slots=SECONDARY_SLOTS, mesh=mesh_arg,
                             device=args.device)

    dist_answers, keys, dist_eng = drive(engine(mesh))
    local_answers, _, _ = drive(engine(None))

    for name in local_answers:
        np.testing.assert_array_equal(np.asarray(dist_answers[name]),
                                      np.asarray(local_answers[name]))
    print(f"OK bit-exact vs unsharded engine "
          f"({len(local_answers)} query/close answers)")
    for t in keys:
        np.testing.assert_array_equal(
            np.asarray(dist_answers[f"c{t}"]),
            histo.oracle(keys[t], BINS, DOMAIN, NUM_PRI))
    print(f"OK oracle-exact ({len(keys)} sessions, Zipf 1.5, ragged appends)")
    assert dist_eng._slot_reschedules > 0, "no lane re-grant ever moved"
    print(f"OK {dist_eng._slot_reschedules} slot re-grants "
          "(cross-shard §IV-B folds)")

    totals = dist_eng.telemetry_record()["extra"]["totals"]
    print(f"sessions={totals['sessions_opened']} flushes={totals['flushes']} "
          f"tuples={totals['tuples_flushed']}")
    return {"answers": len(local_answers), "reschedules": dist_eng._slot_reschedules,
            "totals": totals}


if __name__ == "__main__":
    main()
