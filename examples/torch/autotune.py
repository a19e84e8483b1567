"""Autotuner walkthrough on PyTorch: search (M, X, chunk), then serve
multiple tenants under their own tuned plans (DESIGN.md §6).

The paper picks only X offline (Eq. 2); ``repro_torch.tune.autotune``
also searches the PriPE count around the Eq. 1 balance, cross-checks the
Eq. 2 pick against the X extremes with the port-limited cycle model, and
breaks the remaining tie (chunk size) by measured wall-clock on the
device.  The result is a TunedPlan the executors accept directly.

    PYTHONPATH=src python examples/torch/autotune.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.apps import histo
from repro_torch.core import analyzer, executor
from repro_torch.core.profiler import workload_hist
from repro_torch.data.zipf import zipf_tuples
from repro_torch.serve.engine import StreamEngine
from repro_torch.tune import SearchSpace, autotune, static_plan_from_hist

NUM_BINS, DOMAIN = 512, 1 << 20
N = 1 << 16
ALPHAS = (0.0, 1.5, 3.0)
CHUNK_SIZES = (1024, 4096)
TENANTS = ((0.5, 7), (2.0, 8), (2.0, 9))      # (alpha, seed) a tenant


def factory(m):
    return histo.make_spec(NUM_BINS, DOMAIN, m)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    # ---- offline tuning per skew level (M searched around Eq. 1's M*=16) ----
    print("== autotune over (M, X, chunk), model pass ==")
    for alpha in ALPHAS:
        data = zipf_tuples(N, DOMAIN, alpha, seed=1)
        sample = analyzer.sample_dataset(data, frac=0.1)
        tuned = autotune(factory, sample, tolerance=0.1, device=dev)
        print(f"alpha={alpha}: -> {tuned.num_pri}P+{tuned.num_sec}S, "
              f"chunk={tuned.chunk_size}, "
              f"modeled speedup vs paper default "
              f"{tuned.modeled_speedup_vs_default:.2f}x")

    # ---- measured tiebreak: chunk size by wall-clock --------------------
    data = zipf_tuples(N, DOMAIN, 1.5, seed=1)
    tuned = autotune(
        factory(16), data,
        space=SearchSpace(m_candidates=(16,), chunk_sizes=CHUNK_SIZES),
        tolerance=0.1, measure=True, device=dev)
    print(f"\nmeasured tiebreak picked chunk={tuned.chunk_size} "
          f"({tuned.measured_s * 1e3:.2f} ms/pass); candidates:")
    for c in tuned.measured_candidates:
        print(f"  {c}")

    # ---- the TunedPlan drops into the executor as-is --------------------
    run = executor.make_executor(tuned.spec, tuned, device=dev)
    stream = data.reshape(-1, tuned.chunk_size, 2)
    merged, stats = run(stream, tuned.route_plan)
    ref = histo.oracle(data[:, 0], NUM_BINS, DOMAIN, tuned.num_pri)
    np.testing.assert_array_equal(merged.cpu().numpy(), ref)
    print(f"\nexecutor under TunedPlan: oracle-exact, modeled cycles "
          f"{float(stats.modeled_cycles.double().sum()):.0f}")

    # ---- multi-tenant serving: per-tenant tuned plans -------------------
    # the engine architecture (M, X, chunk) is ONE lane-batched executor,
    # tuned once; what is per-tenant is the ROUTE PLAN -- each tenant's
    # sampled workload is scheduled onto the shared architecture, so tenants
    # with different hot keys balance differently inside the same step
    spec16 = factory(16)
    engine = StreamEngine(spec16, tuned=tuned, max_streams=4, device=dev)
    rids, sizes = {}, {}
    for tenant, (alpha, seed) in enumerate(TENANTS):
        tdata = zipf_tuples(N // 4, DOMAIN, alpha, seed=seed)
        tsample = analyzer.sample_dataset(tdata, frac=0.2)
        dst, _, _ = spec16.pre(torch.as_tensor(tsample, device=dev), engine.num_pri)
        tplan = static_plan_from_hist(workload_hist(dst, engine.num_pri),
                                      engine.num_pri, engine.num_sec)
        rids[tenant] = engine.submit(tdata, plan=tplan)
        sizes[tenant] = len(tdata)
    out = engine.flush()
    print("\nStreamEngine with per-tenant tuned plans:")
    totals = {}
    for tenant, rid in rids.items():
        merged, stats = out[rid]
        totals[tenant] = int(np.asarray(merged).sum())
        assert totals[tenant] == sizes[tenant], (tenant, totals[tenant])
        print(f"  tenant {tenant}: histogram total "
              f"{totals[tenant]}, modeled cycles "
              f"{float(np.asarray(stats.modeled_cycles).sum()):.0f}")
    return {"chunk_size": tuned.chunk_size, "totals": totals}


if __name__ == "__main__":
    main()
