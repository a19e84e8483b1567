"""The port's dry run against the JAX package's compiled one, cell by cell.

For REDUCED llama3.2-3b, moonshot-v1-16b-a3b and whisper-base, training,
prefill and decode at [4, 64], on a (2, 4) ("data", "model") mesh:

- JAX: ``repro.launch.dryrun.build_cell`` on an ``Auto``-axis mesh of 8
  forced host devices, jitted, lowered and compiled; its
  ``memory_analysis().argument_size_in_bytes`` and its HLO's collectives
  (``analysis.parse_collectives``, while bodies times the periods);
- the port: ``repro_torch.launch.dryrun.build_cell`` on a fake 8-rank
  process group, every leaf placed, its per-device argument bytes and its
  spec-derived collectives.

Run from the repository root, on the CPU (it sets its own XLA_FLAGS before
JAX starts, so run it in a process of its own):

    PYTHONPATH=src python tools/dryrun_vs_jax.py          # a table
    PYTHONPATH=src python tools/dryrun_vs_jax.py --json   # one JSON line

Nothing in ``src/repro`` changes: the JAX side builds its mesh itself
(``make_production_mesh`` makes ``Explicit`` axes under jax 0.9, on which
training cells fail in ``with_sharding_constraint``).
"""
from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ARCHS = ("llama3.2-3b", "moonshot-v1-16b-a3b", "whisper-base")
KINDS = ("train", "prefill", "decode")
BATCH, SEQ = 4, 64
MESH = (2, 4)


def jax_cell(arch: str, kind: str) -> dict:
    import jax
    from jax.sharding import AxisType

    from repro.configs import get_reduced
    from repro.configs.base import SHAPES
    from repro.launch import analysis as AN
    from repro.launch import dryrun as JD

    name = f"_dryrun_vs_jax_{kind}"
    SHAPES[name] = dict(kind=kind, seq_len=SEQ, global_batch=BATCH)
    cfg = get_reduced(arch)
    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    step, args, in_sh, out_sh, donate = JD.build_cell(cfg, name, mesh)
    kw = dict(in_shardings=in_sh, donate_argnums=donate)
    if out_sh is not None:
        kw["out_shardings"] = out_sh
    jax.set_mesh(mesh)
    compiled = jax.jit(step, **kw).lower(*args).compile()
    coll = AN.parse_collectives(compiled.as_text(), 8, body_trip=cfg.num_periods)
    return {"argument_bytes": int(compiled.memory_analysis().argument_size_in_bytes),
            "collective_bytes": coll["bytes_moved_total"],
            "collectives": {k: v["count"] for k, v in coll["per_kind"].items()}}


def port_cell(arch: str, kind: str, mesh) -> dict:
    from repro_torch.configs import get_reduced
    from repro_torch.launch import analysis as AN
    from repro_torch.launch import dryrun as D
    cfg = get_reduced(arch)
    shape = dict(kind=kind, seq_len=SEQ, global_batch=BATCH)
    cell = D.build_cell(cfg, shape, mesh)
    D.place_cell(cell, mesh)
    coll = AN.collective_stats(D.cell_collectives(cfg, shape, cell, mesh))
    memory = AN.extract_memory(cell.args, cell.in_shardings,
                               unused_bytes=D.unused_bytes(cell))
    return {"argument_bytes": int(memory["argument_size_in_bytes"]),
            "collective_bytes": coll["bytes_moved_total"],
            "collectives": {k: v["count"] for k, v in coll["per_kind"].items()}}


def compare() -> list:
    import jax
    assert len(jax.devices()) == 8, jax.devices()
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    rows = []
    with D.fake_process_group(8):
        mesh = make_host_mesh(*MESH)
        for arch in ARCHS:
            for kind in KINDS:
                rows.append({"arch": arch, "kind": kind,
                             "jax": jax_cell(arch, kind), "port": port_cell(arch, kind, mesh)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    rows = compare()
    if args.json:
        print(json.dumps(rows))
        return 0
    print("| cell | argument bytes, JAX | port | collective bytes a device, JAX "
          "(compiled) | port (spec rules) | JAX ops | port ops |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        j, p = r["jax"], r["port"]
        print(f"| {r['arch']} {r['kind']} | {j['argument_bytes']} | {p['argument_bytes']} | "
              f"{j['collective_bytes']:.0f} | {p['collective_bytes']:.0f} | "
              f"{j['collectives']} | {p['collectives']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
