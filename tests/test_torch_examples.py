"""The port's examples (``examples/torch/*.py``) run on the CPU.

Each example's ``main(["--device", "cpu"])`` runs with its size constants
shrunk where the full size takes more than a few seconds here, and its own
self-checks (oracle-exact answers, histogram totals, the crash-recovery
harness) must hold.  Quickstart's X picks are also held against the JAX
package's ``Ditto.select`` on the same data.  crash_recovery and
distributed_sessions run at full size: the first re-runs its own file in a
child process, which sees no patched constant.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro.core import Ditto as JDitto
from repro.core import DittoSpec as JDittoSpec
from repro_torch.data.zipf import zipf_tuples
from repro_torch.tree import tree_leaves

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
NAMES = ["autotune", "crash_recovery", "distributed_ditto", "distributed_sessions",
         "moe_ditto", "quickstart", "serve_lm", "skew_sweep", "train_lm"]
CPU = ["--device", "cpu"]


def load(name: str):
    """Import ``examples/torch/<name>.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_every_jax_example_has_a_port():
    jax_examples = {p.stem for p in EXAMPLES.parent.glob("*.py")}
    assert jax_examples == set(NAMES) == {p.stem for p in EXAMPLES.glob("*.py")}


def test_quickstart_picks_jax_x(monkeypatch):
    qs = load("quickstart")
    monkeypatch.setattr(qs, "N", 1 << 14)
    monkeypatch.setattr(qs, "CHUNK", 1024)
    rows = qs.main(CPU)
    assert [r["alpha"] for r in rows] == list(qs.ALPHAS)
    assert all(r["total"] == qs.N for r in rows)

    def jpre(chunk, num_pri):       # the JAX quickstart's Listing 2
        b = jnp.minimum(chunk[..., 0].astype(jnp.int32)
                        // (qs.DOMAIN // qs.NUM_BINS), qs.NUM_BINS - 1)
        return ((b % num_pri).astype(jnp.int32), (b // num_pri).astype(jnp.int32),
                jnp.ones(chunk.shape[:-1], jnp.int32))
    jspec = JDittoSpec(name="histo", pre=jpre, combine="add",
                       init_buffer=lambda n: jnp.zeros((n, -(-qs.NUM_BINS // 16)),
                                                       jnp.int32))
    jditto = JDitto(jspec, chunk_size=qs.CHUNK)
    for row in rows:
        data = zipf_tuples(qs.N, qs.DOMAIN, row["alpha"], seed=1)
        assert row["x"] == jditto.select(data[:, 0], tolerance=0.05, sample_frac=0.05)
    assert rows[0]["x"] < rows[-1]["x"] and rows[-1]["speedup"] > 1


def test_skew_sweep(monkeypatch, capsys):
    sw = load("skew_sweep")
    monkeypatch.setattr(sw, "N", 3 * 1024 + 77)        # ragged: a masked tail
    monkeypatch.setattr(sw, "CHUNK", 1024)
    rows = sw.main(CPU)                                # oracle-checks each run
    assert [r["app"] for r in rows] == [a for a in ("HISTO", "DP", "PR", "HLL", "HHD")
                                        for _ in sw.ALPHAS]
    assert capsys.readouterr().out.startswith("app    alpha   X  speedup")


def test_autotune(monkeypatch):
    at = load("autotune")
    monkeypatch.setattr(at, "N", 1 << 13)
    out = at.main(CPU)                                 # oracle-exact executor
    assert out["chunk_size"] in at.CHUNK_SIZES
    assert out["totals"] == {t: (1 << 13) // 4 for t in range(len(at.TENANTS))}


def test_moe_ditto(monkeypatch):
    md = load("moe_ditto")
    monkeypatch.setattr(md, "T", 512)
    monkeypatch.setattr(md, "GROUP", 128)
    rows = md.main(CPU)
    drops = [r["drop_frac"] for r in rows]
    assert drops[0] > 0.3 and drops[-1] == 0.0         # secondary slots absorb the skew
    assert drops == sorted(drops, reverse=True)


def test_distributed_ditto(monkeypatch):
    dd = load("distributed_ditto")
    monkeypatch.setattr(dd, "N_CHUNKS", 4)
    rows = dd.main(CPU)                                # oracle-exact where no drop
    by = {(r["alpha"], r["sec"]): r for r in rows}
    assert by[(0.0, 0)]["dropped"] == 0
    assert by[(2.0, 0)]["dropped_postplan"] > by[(2.0, dd.NUM_SEC)]["dropped_postplan"]


def test_distributed_sessions():
    out = load("distributed_sessions").main(CPU)       # bit-exact and oracle-exact
    assert out["reschedules"] > 0 and out["totals"]["sessions_opened"] == 12


def test_crash_recovery(tmp_path, capsys):
    info = load("crash_recovery").main([str(tmp_path / "work")] + CPU)
    assert 0 < info["replayed_tuples"]
    assert "OK post-recovery stream + close oracle-exact" in capsys.readouterr().out


def _tiny(cfg):
    return dataclasses.replace(cfg, num_layers=2, d_model=64, num_heads=2,
                               num_kv_heads=1, head_dim=32, d_ff=128, vocab=512)


def test_serve_lm(monkeypatch):
    sl = load("serve_lm")
    monkeypatch.setattr(sl, "SMALL", _tiny(sl.SMALL))
    monkeypatch.setattr(sl, "REQUESTS", 5)
    reqs = sl.main(CPU)                                # every request served in full
    assert len(reqs) == 5 and all(0 <= t < 512 for r in reqs for t in r.out)


def test_train_lm(monkeypatch, tmp_path):
    tl = load("train_lm")
    monkeypatch.setattr(tl, "SMALL", _tiny(tl.SMALL))
    ckpt = str(tmp_path / "ckpt")
    state = tl.main(CPU + ["--steps", "3", "--seq", "32", "--ckpt", ckpt])
    assert int(state.step) == 3
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params))
