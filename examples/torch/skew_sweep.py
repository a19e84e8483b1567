"""All five paper applications under a Zipf sweep, with the skew analyzer
picking the implementation per (app, dataset) -- paper Fig. 6 workflow,
on PyTorch.

The stream length is deliberately NOT a multiple of the chunk size: the
data pipeline pads the ragged tail into a masked final chunk
(``chunk_stream(pad_tail=True)``) and the executor's validity-mask path
makes the padding an exact no-op -- no hand-rolled tail handling.  Every
run's merged buffers are held against the app's numpy oracle.

The X=0 baselines for every skew level run CONCURRENTLY through the
multi-stream executor (one lane-batched step per app, one stream per
alpha); the analyzer-selected implementation then runs per dataset.

    PYTHONPATH=src python examples/torch/skew_sweep.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.apps import dp, hhd, histo, hll, pagerank
from repro_torch.core import Ditto
from repro_torch.data.pipeline import chunk_stream
from repro_torch.data.zipf import zipf_tuples
from repro_torch.tree import tree_map

N = (1 << 16) + 777          # ragged on purpose: tail rides the mask path
CHUNK = 4096
ALPHAS = (0.0, 2.0)


def apps():
    """name -> (spec, oracle of the valid tuples, the merged buffers' answer
    as numpy)."""
    def dense(merged):
        return merged.cpu().numpy()
    return {
        "HISTO": (histo.make_spec(512, 1 << 20, 16),
                  lambda t: histo.oracle(t[:, 0], 512, 1 << 20, 16), dense),
        "DP": (dp.make_spec(4, 16, capacity_per_pe=4 * N),
               lambda t: dp.oracle(t, 4), lambda m: dp.partitions_from_buffers(m, 16)),
        "PR": (pagerank.make_spec(1 << 12, 16),
               lambda t: scatter_oracle(t, 1 << 12, 16), dense),
        "HLL": (hll.make_spec(12, 16), lambda t: hll.oracle(t[:, 0], 12, 16), dense),
        "HHD": (hhd.make_spec(4, 1024, 16),
                lambda t: hhd.oracle(t[:, 0], 4, 1024, 16), dense),
    }


def scatter_oracle(tuples: np.ndarray, num_vertices: int, num_pri: int) -> np.ndarray:
    """PageRank's scatter phase: the int32 (wrapping) sums of the tuples'
    values at their vertices, partitioned as the spec's PEs."""
    dst = tuples[:, 0].astype(np.int64)
    out = np.zeros((num_pri, -(-num_vertices // num_pri)), np.int64)
    np.add.at(out, (dst % num_pri, dst // num_pri), tuples[:, 1])
    return out.astype(np.int32)


def check(name, answer, want):
    if isinstance(want, list):                 # DP: partitions as multisets
        assert len(answer) == len(want) and all(
            dp.multiset_equal(a, w) for a, w in zip(answer, want)), \
            f"{name}: partitions differ from the oracle"
    else:
        np.testing.assert_array_equal(answer, want, err_msg=name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rows = []
    print(f"{'app':6s} {'alpha':>5s} {'X':>3s} {'speedup':>8s}")
    for name, (spec, oracle, answer) in apps().items():
        d = Ditto(spec, chunk_size=CHUNK, device=args.device)
        datasets = []
        for alpha in ALPHAS:
            data = zipf_tuples(N, 1 << 20, alpha, seed=2)
            if name == "PR":
                data[:, 0] = data[:, 0] % (1 << 12)    # vertex ids
            datasets.append(chunk_stream(data, d.chunk_size, pad_tail=True))
        # all alphas' X=0 baselines in one lane-batched run (streams = skew levels)
        baseline = d.generate([0])[0]
        streams = np.stack([ts.body for ts in datasets])
        masks = np.stack([ts.mask for ts in datasets])
        m0, s0 = baseline.run_streams(streams, mask=masks)
        for i, (alpha, ts) in enumerate(zip(ALPHAS, datasets)):
            valid = ts.body.reshape(-1, *ts.body.shape[2:])[ts.mask.ravel()]
            keys, want = valid[:, 0], oracle(valid)
            check(f"{name} alpha={alpha} X=0", answer(tree_map(lambda t: t[i], m0)), want)
            x = d.select(keys, tolerance=0.05)
            mx, sx = d.generate([x])[0].run(torch.as_tensor(ts.body),
                                            mask=torch.as_tensor(ts.mask))
            check(f"{name} alpha={alpha} X={x}", answer(mx), want)
            sp = float(s0.modeled_cycles[i].double().sum()
                       / sx.modeled_cycles.double().sum())
            print(f"{name:6s} {alpha:5.1f} {x:3d} {sp:8.2f}x")
            rows.append({"app": name, "alpha": alpha, "x": x, "speedup": sp})
    return rows


if __name__ == "__main__":
    main()
