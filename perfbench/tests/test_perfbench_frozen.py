"""The benchmark's frozen copies equal the program's arithmetic today, at
the cell's shapes: the Zipf law of the streams, and the cell count behind
the chunk steps' roofline."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import roofline, zipf
from perfbench.reference import histo as ref_histo
from perfbench.tests import tiny


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0, 1.5, 2.0, 3.0])
def test_zipf_law_equals_the_programs(alpha):
    """Fed the program's uniforms and permutation, ``keys_of`` gives the
    program's keys; only the random source differs."""
    from repro_torch.data import zipf as port
    n, domain = (1 << 18) - 1234, 1 << 20
    seed = zipf.derive(2**31 + 5, 1, 7)
    np.testing.assert_array_equal(zipf.cdf(domain, alpha), np.cumsum(port._zipf_pmf(domain, alpha)))
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    perm = rng.permutation(domain)
    got = zipf.keys_of(torch.as_tensor(u), torch.as_tensor(zipf.cdf(domain, alpha)),
                       torch.as_tensor(perm))
    np.testing.assert_array_equal(got.numpy(), port.zipf_keys(n, domain, alpha, seed=seed))


def test_zipf_tuples_repeat_with_the_seed_and_keep_their_ranges():
    a = zipf.zipf_tuples(5000, 1 << 20, 1.5, 2**31 + 9, "cpu")
    assert a.dtype == torch.int32 and a.shape == (5000, 2)
    assert torch.equal(a, zipf.zipf_tuples(5000, 1 << 20, 1.5, 2**31 + 9, "cpu"))
    assert not torch.equal(a, zipf.zipf_tuples(5000, 1 << 20, 1.5, 2**31 + 10, "cpu"))
    assert int(a[:, 0].min()) >= 0 and int(a[:, 0].max()) < 1 << 20
    assert int(a[:, 1].min()) >= 0


@pytest.mark.parametrize("alpha", [0.0, 1.0, 3.0])
def test_zipf_tuples_follow_the_law(alpha):
    """The rank of the most frequent key takes its share of the law."""
    n, domain = 1 << 17, 1 << 10
    keys = zipf.zipf_tuples(n, domain, alpha, 2**31 + 3, "cpu")[:, 0].numpy()
    top = np.bincount(keys, minlength=domain).max() / n
    p1 = np.diff(np.concatenate([[0.0], zipf.cdf(domain, alpha)]))[0]
    assert top == pytest.approx(p1, abs=5 * np.sqrt(p1 / n) + 4e-3)


def test_derived_seeds_differ_and_repeat():
    seeds = {zipf.derive(s, r, t) for s in (0, 1, 2**31 + 3) for r in range(3)
             for t in range(16)}
    assert len(seeds) == 3 * 3 * 16
    assert zipf.derive(2**33, 1, 2) == zipf.derive(2**33, 1, 2)
    assert all(0 <= s < 2**62 for s in seeds)


@pytest.mark.parametrize("alpha", [0.0, 1.0, 3.0])
def test_cells_touched_are_the_distinct_pripe_cells_of_each_chunk(alpha):
    """The chunk step's cell count: the distinct (PriPE, local index)
    pairs the program's HISTO PrePE gives each chunk's keys."""
    from repro_torch.apps import histo
    cfg = tiny.load("configs", "ditto-histo")
    chunk, m = cfg["chunk_size"], cfg["num_pri"]
    keys = zipf.zipf_tuples(5 * chunk - 77, cfg["key_domain"], alpha, 3, "cpu").numpy()
    spec = histo.make_spec(cfg["num_bins"], cfg["key_domain"], m)
    want = 0
    for i in range(0, len(keys), chunk):
        dst, idx, _ = spec.pre(torch.as_tensor(keys[i:i + chunk]), m)
        want += len(set(zip(dst.tolist(), idx.tolist())))
    assert ref_histo.cells_touched(keys[:, 0], cfg["num_bins"], cfg["key_domain"],
                                   chunk) == want
    assert roofline.chunk_step_bytes(len(keys), want, tuple_bytes=12) == \
        len(keys) * 12 + 2 * 4 * want
