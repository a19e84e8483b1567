"""The reader of ``executor.plan_step_share``: the share of chunk steps
whose staged span holds an ``executor.plan`` stage.  A known answer on a
hand-built trace, nothing read where the stage is absent (a program
without it) or the steps are not one a chunk step, and a tiny traced CPU
run of the stream cell."""
from __future__ import annotations

import pytest

from perfbench.drivers import stream
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_spans import BATCH, _read, _trace

NAME = "executor.plan_step_share"

# BATCH's first step with its schedule stage split: the plan, then the rest
PLANNED = [e for e in BATCH if e[0] != "executor.schedule"] + [
    ("executor.plan", 3.7, 3.9), ("executor.schedule", 3.9, 4.0),
    ("executor.schedule", 5.5, 6.0)]


def test_plan_step_share_counts_the_steps_with_a_plan_stage():
    """The first step generates a plan, the second is settled: one full
    step in two.  The schedule stage's own reader sees only what is left
    of it."""
    assert _read(NAME, _trace(host=PLANNED)) == pytest.approx(50.0)
    assert _read("executor.schedule_us_per_step", _trace(host=PLANNED)) == pytest.approx(0.30e6)


@pytest.mark.parametrize("host", [BATCH, [("aten::add", 1.0, 2.0), ("stream.flush", 0.5, 9.0)]],
                         ids=["no_plan_stage", "no_spans"])
def test_absent_plan_spans_read_nothing(host):
    assert _read(NAME, _trace(host=host)) is None


def test_steps_that_are_not_one_a_chunk_step_read_nothing():
    assert _read(NAME, _trace(host=PLANNED, steps=3)) is None


def test_a_traced_cpu_run_reads_the_plan_step_share():
    """A flush's first step of two takes the lanes' plans; the second is
    settled."""
    cell = tiny.cell(tiny.histo_config(), tiny.stream_traffic(),
                     tiny.load("limits", "histo-sweep"), trace=True)
    out = stream.run(cell)
    assert out.correct
    assert _read(NAME, out.trace) == pytest.approx(50.0)
