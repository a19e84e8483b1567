"""Quickstart on PyTorch: the paper's developer experience in ~15 lines of
user code, on the card (or the CPU with ``--device cpu``).

You write the `pre` rule (tuple -> <dst, idx, value>) and pick a combine
op; Ditto generates the implementation family, profiles a sample of your
data (Eq. 2 skew analyzer), picks the cheapest skew-robust variant, and
runs the skew-oblivious streaming executor (profiler -> scheduler ->
mapper -> merger, with the PE update in the hand-written CUDA kernel).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Ditto, DittoSpec
from repro_torch.data.zipf import zipf_tuples

NUM_BINS, DOMAIN = 512, 1 << 20
N, CHUNK = 1 << 17, 4096
ALPHAS = (0.0, 1.5, 3.0)


# ----- the paper's Listing 2, PyTorch edition: 6 lines of application logic
def pre(chunk, num_pri):
    b = torch.clamp(chunk[..., 0].to(torch.int32) // (DOMAIN // NUM_BINS),
                    max=NUM_BINS - 1)
    return ((b % num_pri).to(torch.int32), (b // num_pri).to(torch.int32),
            torch.ones(chunk.shape[:-1], dtype=torch.int32, device=chunk.device))


def init_buffer(n, device):
    return torch.zeros((n, -(-NUM_BINS // 16)), dtype=torch.int32, device=device)
# -------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = DittoSpec(name="histo", pre=pre, combine="add", init_buffer=init_buffer)
    ditto = Ditto(spec, chunk_size=CHUNK, device=args.device)
    print(f"Eq.1 pipeline balance -> {ditto.num_pre} PrePEs, "
          f"{ditto.num_pri} PriPEs")

    rows = []
    for alpha in ALPHAS:
        data = zipf_tuples(N, DOMAIN, alpha, seed=1)
        # skew analyzer pick (Eq. 2) over a 5% sample
        x = ditto.select(data[:, 0], tolerance=0.05, sample_frac=0.05)
        impl = ditto.generate([x])[0]
        merged, stats = impl.run(ditto.chunk(data))

        base, bstats = ditto.generate([0])[0].run(ditto.chunk(data))
        np.testing.assert_array_equal(merged.cpu().numpy(), base.cpu().numpy())
        speedup = float(bstats.modeled_cycles.double().sum()
                        / stats.modeled_cycles.double().sum())
        total = int(merged.sum())
        assert total == N, f"histogram total {total} != {N} tuples"
        print(f"alpha={alpha}: Ditto picked X={x:2d} SecPEs "
              f"(buffer capacity frac {impl.buffer_capacity_fraction:.2f}), "
              f"modeled speedup over X=0: {speedup:.1f}x, "
              f"histogram total={total}")
        rows.append({"alpha": alpha, "x": x, "speedup": speedup, "total": total})
    return rows


if __name__ == "__main__":
    main()
