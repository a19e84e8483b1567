"""A run with the timed path broken underneath comes out not correct, and
the control fails the limits.  The harness's look for a chip is skipped:
each test drives the rest of a run on the CPU at a small size, with the
cell's own limits; a sound run at that size comes out correct."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench.drivers import stream
from perfbench.reference import histo as ref
from perfbench.tests import tiny


def _stream_cell(**kw):
    return tiny.cell(tiny.histo_config(), tiny.stream_traffic(),
                     tiny.load("limits", "histo-sweep"), **kw)


def _engine_with(fault):
    """A StreamEngine whose lane-batched executor is broken by ``fault``."""
    from repro_torch.serve.engine import StreamEngine

    class Broken(StreamEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            run_streams = self._run_streams

            def broken(tuples, plans=None, mask=None):
                return fault(run_streams, tuples, plans, mask)

            self._run_streams = broken

    return Broken


def _unchanged_state(run_streams, tuples, plans, mask):
    merged, stats = run_streams(tuples, plans, mask=mask)
    return torch.zeros_like(merged), stats


def _half_the_lanes(run_streams, tuples, plans, mask):
    if mask is None:
        mask = torch.ones(tuples.shape[:3], dtype=torch.bool)
    mask = mask.clone()
    mask[mask.shape[0] // 2:] = False
    return run_streams(tuples, plans, mask=mask)


def _altered_answer(run_streams, tuples, plans, mask):
    merged, stats = run_streams(tuples, plans, mask=mask)
    merged[0, 0, 0] += 1
    return merged, stats


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_stream_run_is_correct(trace):
    out = stream.run(_stream_cell(trace=trace))
    assert out.correct and out.attempted > 0 and out.metrics["tuples_per_s"] > 0


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_lanes, _altered_answer])
def test_a_broken_stream_run_is_not_correct(fault):
    out = stream.run(_stream_cell(), engine_factory=_engine_with(fault))
    assert not out.correct
    assert out.failed > 0 and out.checks[0].value > out.checks[0].limit


def _control_bins_wrong(cell) -> list:
    cfg = cell.config
    out = []
    for data in stream.make_streams(cell):
        keys = data[:, 0]
        out.append(ref.bins_wrong(
            ref.control_histogram(keys, cfg["num_bins"], cfg["key_domain"]),
            ref.histogram(keys, cfg["num_bins"], cfg["key_domain"])))
    return out


def test_the_histo_control_fails_the_limit():
    """At 2^17 tuples a stream the skewed streams' top bins pass int16."""
    cell = _stream_cell()
    cell = dataclasses.replace(cell, config=dict(cell.config, dataset_tuples=1 << 17))
    wrong = _control_bins_wrong(cell)
    assert wrong[0] == 0 and wrong[-1] > 0
    assert sum(wrong) > cell.limits["bins_wrong"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the streams of the cell's own size are made there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_the_histo_control_fails_at_the_cells_own_size(card, seed):
    from perfbench import harness
    found = harness.resolve(harness.ROOT, "histo-sweep")
    cell = harness.Cell(name="histo-sweep", config=found["config"],
                        traffic=found["traffic"], limits=found["limits"], seed=seed,
                        seconds=0.0, trace=False, device=card, chips=1, t0=0.0)
    wrong = _control_bins_wrong(cell)
    print(f"control int16 seed {seed}: bins wrong a stream {wrong}, "
          f"limit {cell.limits['bins_wrong']}")
    assert sum(wrong) > cell.limits["bins_wrong"]
