"""The readers of the program's spans (``perfbench/spans.py`` and the
metrics built on it): known answers on hand-built traces, nothing read
where the spans are absent or are not one a chunk step, and a tiny traced
CPU run of the stream cell in which every host-span metric reads."""
from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from perfbench import harness, spans
from perfbench.drivers import stream
from perfbench.tests import tiny
from perfbench.trace import Trace

HOST = ["stream.engine_us_per_step", "stream.drain_share", "executor.route_us_per_step",
        "executor.pe_update_us_per_step", "executor.schedule_us_per_step"]
NEW = [*HOST, "device_idle.stream.engine"]

# one batch of two chunk steps in a 10 s window: (name, start, end) in s
BATCH = [("stream.batch", 1.0, 9.0), ("stream.stack", 1.0, 2.0), ("executor.load", 2.0, 3.0),
         ("executor.step", 3.0, 4.0), ("executor.route", 3.0, 3.5),
         ("executor.pe_update", 3.5, 3.7), ("executor.schedule", 3.7, 4.0),
         ("executor.step", 4.0, 6.0), ("executor.route", 4.0, 5.0),
         ("executor.pe_update", 5.0, 5.5), ("executor.schedule", 5.5, 6.0),
         ("executor.finish", 6.0, 7.0), ("stream.drain", 7.0, 8.0),
         ("stream.collect", 8.0, 9.0), ("aten::add", 3.1, 3.2)]
BUSY = [(0.5, 1.5), (3.2, 3.8), (5.0, 7.5)]


def _trace(host=BATCH, busy=BUSY, steps=2, window=10.0) -> Trace:
    return Trace(window_s=window, dev_names=["k"] * len(busy),
                 dev_start=np.asarray([a for a, _ in busy], float),
                 dev_end=np.asarray([b for _, b in busy], float),
                 cpu_names=[n for n, _, _ in host],
                 cpu_start=np.asarray([a for _, a, _ in host], float),
                 cpu_end=np.asarray([b for _, _, b in host], float),
                 cpu_counts=Counter(n for n, _, _ in host), work={"chunk_steps": steps})


def _read(name, trace):
    return harness.reader(harness.ROOT, name)(trace)


def test_union_length_and_overlap():
    iv = np.asarray([[3.0, 4.0], [0.0, 1.0], [0.5, 2.0], [2.0, 2.5]])
    assert spans.union(iv).tolist() == [[0.0, 2.5], [3.0, 4.0]]
    assert spans.length(iv) == pytest.approx(3.5)
    assert spans.overlap(np.asarray([[1.0, 3.5]]), iv) == pytest.approx(2.0)
    assert spans.overlap(iv, np.zeros((0, 2))) == 0.0


def test_the_readers_on_a_known_trace():
    t = _trace()
    # the batch's 8 s less the steps' 3 s and the drain's 1 s, over 2 steps
    assert _read("stream.engine_us_per_step", t) == pytest.approx(2.0e6)
    assert _read("stream.drain_share", t) == pytest.approx(10.0)
    assert _read("executor.route_us_per_step", t) == pytest.approx(0.75e6)
    assert _read("executor.pe_update_us_per_step", t) == pytest.approx(0.35e6)
    assert _read("executor.schedule_us_per_step", t) == pytest.approx(0.40e6)
    # idle 5.9 s of 10; of it, 1.4 s falls inside the steps [3, 6]
    assert _read("device_idle.stream", t) == pytest.approx(59.0)
    assert _read("device_idle.stream.engine", t) == pytest.approx(45.0)


def test_engine_time_is_self_time_of_the_batches():
    """Two batches, a step straddling nothing outside them, and a drain
    nested in a step: the covered time is counted once."""
    host = [("stream.batch", 0.0, 4.0), ("executor.step", 1.0, 3.0),
            ("stream.drain", 2.5, 3.5), ("stream.batch", 5.0, 6.0),
            ("executor.step", 5.5, 5.75)]
    t = _trace(host=host, busy=[(0.0, 6.0)])
    # (4 - 2.5) + (1 - 0.25) over 2 steps
    assert _read("stream.engine_us_per_step", t) == pytest.approx(1e6 * 2.25 / 2)
    assert _read("device_idle.stream.engine", t) == pytest.approx(40.0)


@pytest.mark.parametrize("name", NEW)
def test_absent_spans_read_nothing(name):
    t = _trace(host=[("aten::add", 1.0, 2.0), ("stream.flush", 0.5, 9.0)])
    assert _read(name, t) is None


@pytest.mark.parametrize("name", [n for n in NEW if n != "stream.drain_share"])
def test_steps_that_are_not_one_a_chunk_step_read_nothing(name):
    assert _read(name, _trace(steps=3)) is None


def test_a_traced_cpu_run_reads_every_host_span_metric():
    cell = tiny.cell(tiny.histo_config(), tiny.stream_traffic(),
                     tiny.load("limits", "histo-sweep"), trace=True)
    out = stream.run(cell)
    t = out.trace
    assert out.correct
    assert len(spans.intervals(t, "executor.step")) == t.work["chunk_steps"] > 0
    for name in HOST:
        value = _read(name, t)
        assert value is not None and value >= 0.0, name
    assert _read("executor.route_us_per_step", t) > 0
    # no device on the CPU: the device's shares read nothing
    assert _read("device_idle.stream.engine", t) is None
    assert _read("device_idle.stream", t) is None
