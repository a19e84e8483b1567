#!/usr/bin/env python3
"""Run each of the port's examples (``examples/torch/*.py``) at full size,
each in a process of its own, and report its wall time.

    PYTHONPATH=src python tools/run_examples.py [--device cpu] [--out DIR]

On ``cuda`` it first prints the card's name and power limit as
``nvidia-smi`` gives them and builds every kernel in a process of its own
(its wall seconds are the ``build`` line), so that no example's time holds
a build.  Then one JSON line an example: its name, exit code and wall
seconds (the process's start included).
Each example runs from the repository's root with its own empty TMPDIR,
so that train_lm starts from no checkpoint; its output goes to
DIR/<name>.log (default build/examples).  Exits non-zero if any example fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples" / "torch"
TIMEOUT_S = 600.0  # per example, and for the build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(REPO / "build" / "examples"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                               if p]))
    if args.device.startswith("cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c",
                        "from repro_torch.kernels import _build; _build.build()"],
                       cwd=REPO, env=env, check=True, timeout=TIMEOUT_S)
        print(json.dumps({"build": time.perf_counter() - t0}), flush=True)
    failed = []
    for script in sorted(EXAMPLES.glob("*.py")):
        with tempfile.TemporaryDirectory() as tmp, \
                open(out / f"{script.stem}.log", "w") as log:
            t0 = time.perf_counter()
            try:
                rc = subprocess.run([sys.executable, str(script), "--device", args.device],
                                    cwd=REPO, env=dict(env, TMPDIR=tmp), stdout=log,
                                    stderr=subprocess.STDOUT, timeout=TIMEOUT_S).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
            seconds = time.perf_counter() - t0
        print(json.dumps({"example": script.stem, "rc": rc, "seconds": seconds}), flush=True)
        if rc != 0:
            failed.append(script.stem)
    if failed:
        print(f"failed: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
