"""The plain reference against the program's CPU path: HISTO's
histogram equals the program's oracle, and its control is the histogram
held in int16."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench import zipf
from perfbench.reference import histo as ref_histo
from perfbench.tests import tiny


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0, 2.0, 3.0])
def test_histogram_equals_the_programs_oracle(alpha):
    from repro_torch.apps import histo
    from perfbench.drivers.stream import flat_histogram
    cfg = tiny.load("configs", "ditto-histo")
    keys = zipf.zipf_tuples(50_000, cfg["key_domain"], alpha, 11, "cpu")[:, 0].numpy()
    want = histo.oracle(keys, cfg["num_bins"], cfg["key_domain"], cfg["num_pri"])
    np.testing.assert_array_equal(
        ref_histo.histogram(keys, cfg["num_bins"], cfg["key_domain"]),
        flat_histogram(want, cfg["num_bins"]))


def test_control_histogram_wraps_past_int16():
    keys = np.array([5] * 40000 + [1500] * 3 + [2000], np.int64)
    got = ref_histo.control_histogram(keys, 4, 4000)
    np.testing.assert_array_equal(got, [40000 - 65536, 3, 1, 0])
    assert ref_histo.bins_wrong(got, ref_histo.histogram(keys, 4, 4000)) == 1
