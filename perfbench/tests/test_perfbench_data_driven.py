"""The harness is driven by data: a new configuration, traffic mix, limits
and per-layer metric, each a new file with an entry in BENCHMARK.json,
are found by name with no edit to a file that is there.  And
BENCHMARK.json keeps to its contract's shapes: names, units, keys,
lengths, and cells that each report what their metrics move."""
from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from perfbench import harness
from perfbench.tests import tiny

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_metric_and_traffic_are_found_by_name(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "perfbench")
    pb = tmp_path / "perfbench"
    (pb / "configs" / "ditto-histo-wide.json").write_text(
        json.dumps(dict(tiny.load("configs", "ditto-histo"), num_bins=4096)))
    (pb / "traffic" / "zipf-mixed.json").write_text(
        json.dumps(dict(tiny.load("traffic", "zipf-sweep"), alphas=[0.0, 3.0] * 4)))
    (pb / "limits" / "histo-wide-mixed.json").write_text(
        json.dumps({"bins_wrong": 0, "results_missing": 0}))
    (pb / "metrics" / "stream.chunk_steps.py").write_text(
        "def read(trace):\n    return trace.work.get('chunk_steps')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ditto-histo-wide", "source": "https://arxiv.org/abs/2105.04151",
                             "file": "perfbench/configs/ditto-histo-wide.json",
                             "reduced": [], "why": "wider bins"})
    bench["workloads"].append({"name": "histo-wide-mixed", "config": "ditto-histo-wide",
                               "traffic": "zipf-mixed", "chips": 1, "why": "mixed"})
    bench["end_to_end"][1]["workloads"].append("histo-wide-mixed")
    bench["per_layer"].append({"name": "stream.chunk_steps", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "executor and routing", "moves": "tuples_per_s",
                               "workloads": ["histo-wide-mixed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(pb)
    assert all(after[p] == d for p, d in before.items()), "an existing file changed"
    found = harness.resolve(tmp_path, "histo-wide-mixed")
    assert found["config"]["num_bins"] == 4096
    assert found["traffic"]["alphas"][:3] == [0.0, 3.0, 0.0]
    assert found["limits"] == {"bins_wrong": 0, "results_missing": 0}
    assert harness.driver(found["traffic"]).__name__ == "perfbench.drivers.stream"
    names = [m["name"] for m in harness.per_layer_of(found["bench"], "histo-wide-mixed")]
    assert names == ["stream.chunk_steps"]
    assert [m["name"] for m in harness.end_to_end_of(found["bench"], "histo-wide-mixed")] \
        == ["setup_s", "tuples_per_s"]

    class Trace:
        work = {"chunk_steps": 128}
    assert harness.reader(tmp_path, "stream.chunk_steps")(Trace()) == 128


def _names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            yield section, entry


@pytest.mark.parametrize("section,entry", list(_names()),
                         ids=lambda v: v if isinstance(v, str) else v["name"])
def test_names_units_and_keys_keep_to_the_contract(section, entry):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    assert set(entry) <= keys[section]
    assert NAME.match(entry["name"])
    for text in ("why", "layer", "source"):
        if text in entry:
            assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text] \
                and "\t" not in entry[text]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    if section == "configs":
        assert PATH.match(entry["file"]) and entry["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
        config = harness.load_json(harness.ROOT / entry["file"])
        assert sorted(config["published"]) == sorted(entry["reduced"])
        assert all(k in config for k in entry["reduced"])
    if section == "workloads":
        assert entry["chips"] in (1, 4) and NAME.match(entry["traffic"])
        assert (harness.ROOT / "perfbench" / "traffic" / f"{entry['traffic']}.json").exists()
        assert (harness.ROOT / "perfbench" / "limits" / f"{entry['name']}.json").exists()
    if section == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0 < entry["bound"] <= 0.25
    if section == "per_layer":
        assert (harness.ROOT / "perfbench" / "metrics" / f"{entry['name']}.py").exists()
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[entry["moves"]]
        for cell in entry["workloads"]:
            assert entry["moves"] in [m["name"] for m in harness.end_to_end_of(BENCH, cell)]
        if entry["name"].endswith("_roofline") or "_roofline." in entry["name"] \
                or "mfu" in entry["name"]:
            assert entry["unit"] == "%"
        assert moved


def test_the_benchmark_as_a_whole_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
    used = {w["config"] for w in cells}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert {m["name"]: m for m in BENCH["end_to_end"]}["setup_s"]["bound"] <= 0.25
    for w in cells:
        e2e = [m["name"] for m in harness.end_to_end_of(BENCH, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_of(BENCH, w["name"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"stream serving", "executor and routing", "model step", "kernels",
                      "device"}
    # a full check with all 24 cells fits into its 43200 seconds
    run = BENCH["run_seconds"]
    assert 1 <= run <= 51
    assert 1200 + (2 + 14 * 24) * (run + 60) + 24 * 2 * 90 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
