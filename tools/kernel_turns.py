#!/usr/bin/env python3
"""Time the PE update and the MoE dispatch of two or more checkouts of the
port on one NVIDIA GPU, in turns (A, B, B, A), so that their numbers
compare within one call on one card.

    python3 tools/kernel_turns.py PARENT_ROOT .

Each turn is a process of its own that imports ``repro_torch`` from
``ROOT/src`` (building its kernels into ``ROOT/build``) and times, on
inputs made from a seed:
  - ``dispatch.pe_buffer_update`` (max) at the first chunk of an HLL
    alpha = 3 stream (p = 12, M = 16, X = 14), against
    ``scatter_reduce_(amax)`` timed in turns with it;
  - ``dispatch.onehot_dispatch`` at moonshot's prefill shape (G = 8,
    T = 3072, 72 slots x 60, D = 2048 bf16) and at its serving-load decode
    shape (G = 1, T = 384, 72 slots x 7), slots by occurrence rank as on the
    model path, against ``zero_()`` + ``index_put_(accumulate=True)``;
  - ``dispatch.flash_attention`` in bf16 at the model shapes of
    ``FLASH_SHAPES`` (moonshot's prefill, gemma2's with cap 50 and cap 0,
    MLA's dh 192, phi-3's dh 96, Jamba's GQA 64/8, whisper's non-causal
    encoder and cross-attention) against SDPA (no cap), and its card time
    alone (``FLASH_KERNELS``: either tree's bf16 kernel); each root's
    ``max_abs_err`` against the plain version on float32 copies, since a
    redesigned kernel's bf16 output may differ from another's in its last
    bits.  Its float32 outputs at moonshot's and gemma2's shapes are
    hashed, and the roots' hashes must agree (``identical``);
  - ``flash_attention_bwd`` in bf16 at phase G's timed shapes
    (``chip_smoke.G_BWD_TIMED``: llama3.2-3b's training shape, gemma2's
    with cap 50, whisper's encoder and cross), against aten's flash
    backward (``chip_smoke.sdpa_flash_bwd``, no cap), on an output and a
    log-sum-exp from plain PyTorch (``plain_o_lse``), so that both roots'
    backwards see the same bits.  Hashed: bf16 dk and dv (summed in a fixed
    order) and float32 dq, dk and dv; bf16 dq is summed by atomics and
    varies in its last bits.
  - ``ssd``: mamba2-780m's prefill at full width and depth (48 layers,
    seeded weights, [4, 1024] bf16, phase E (h)'s shape) under no_grad: ms
    a forward, and a hash of its logits (the SSD has no kernel; this times
    the plain PyTorch SSD of each root).
  - ``train``: mamba2-780m's training step at full width and depth
    (``chip_smoke.train_steps``: adamw, [2, 1024] bf16 compute, 5 steps on
    one fixed batch): ms a step after the first (host clock, each step
    ends in reading its loss), the peak memory, and a hash of the losses.
``ms`` is a call's time from CUDA events over back-to-back calls;
``device_ms`` the card's time of every kernel and memset a call launches,
from ``chip_smoke.device_ms`` (null where torch.profiler missed launches).
The timing helpers and the library yardsticks are ``chip_smoke.py``'s.
Prints one JSON line a turn, the card's name and power limit, then the
mean of each number per root (null if any turn's is null).

    python3 tools/kernel_turns.py --only bwd PARENT_ROOT .

times only the named groups (``route``, ``dispatch``, ``flash``, ``bwd``,
``ssd``, ``train``).  ``identical`` says, for each hashed output, whether every turn
of every root gave the same bits.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
SEED = 3
GROUPS = ("route", "dispatch", "flash", "bwd", "ssd", "train")
# the backward's kernels: Delta, then dK/dV and dQ (before the redesign) or
# the one-pass tile kernel and the conversion; three a bf16 call either way
BWD_KERNELS = ("delta_kernel", "dkdv_kernel", "dq_kernel", "bwd_tile_kernel",
               "bwd_convert_kernel")
# the bf16 forward: the mma.sync kernel (before the Hopper redesign) or the
# wgmma one; one a call either way
FLASH_KERNELS = ("flash_bf16_kernel", "flash_wgmma_kernel")
# (name, B, Sq, Sk, H, KV, dh, causal, cap): PERF.md's row 5 shapes
FLASH_SHAPES = (("moonshot", 4, 1024, 1024, 16, 16, 128, True, 0.0),
                ("gemma2_cap50", 4, 1024, 1024, 8, 4, 256, True, 50.0),
                ("gemma2_cap0", 4, 1024, 1024, 8, 4, 256, True, 0.0),
                ("mla", 4, 1024, 1024, 16, 16, 192, True, 0.0),
                ("phi3", 1, 2048, 2048, 32, 32, 96, True, 0.0),
                ("jamba", 1, 1024, 1024, 64, 8, 128, True, 0.0),
                ("whisper_encoder", 4, 1500, 1500, 8, 8, 64, False, 0.0),
                ("whisper_cross", 4, 448, 1500, 8, 8, 64, False, 0.0))


def child(root: Path, groups: tuple[str, ...] = GROUPS) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(REPO))
    from repro_torch.kernels import dispatch
    assert Path(dispatch.__file__).resolve().is_relative_to(root.resolve())
    dev = torch.device("cuda", 0)
    out = {"root": str(root), "digests": {}}
    if "route" in groups:
        out.update(time_route(dev))
    if "dispatch" in groups:
        out.update(time_dispatch(dev, root))
    if "flash" in groups:
        flash = time_flash(dev)
        out["digests"].update(flash.pop("digests"))
        out.update(flash)
    if "bwd" in groups:
        bwd, digests = time_bwd(dev)
        out.update(bwd)
        out["digests"].update(digests)
    if "ssd" in groups:
        ssd, digest = time_ssd(dev)
        out["ssd_prefill"] = ssd
        out["digests"]["ssd_prefill_logits"] = digest
    if "train" in groups:
        step, digest = time_train(dev)
        out["mamba2_train_step"] = step
        out["digests"]["mamba2_train_losses"] = digest
    return out


def time_route(dev) -> dict:
    from chip_smoke import CHUNK, chunk_inputs, cuda_ms_turns, device_ms
    from repro_torch.apps import hll
    from repro_torch.data.zipf import zipf_tuples
    from repro_torch.kernels import dispatch
    out = {}
    spec = hll.make_spec(12, 16)
    eff, idx, val = chunk_inputs(spec, zipf_tuples(CHUNK, 1 << 22, 3.0, seed=SEED), 14, dev)
    buf = spec.init_buffer(30, dev)
    flat = eff.long() * buf.shape[1] + idx.long()
    lib_buf = buf.clone().view(-1)
    fn = lambda: dispatch.pe_buffer_update(buf, eff, idx, val, "max")
    turns = cuda_ms_turns({"kernel": fn, "library": lambda: lib_buf.scatter_reduce_(
        0, flat, val, "amax")})
    out["route_accumulate"] = {"ms": turns["kernel"], "library_ms": turns["library"],
                               "device_ms": device_ms(fn, "route_accumulate_")}
    return out


def time_dispatch(dev, root: Path) -> dict:
    from chip_smoke import cuda_ms_turns, device_ms, library_dispatch
    from repro_torch.kernels import dispatch, ops
    out = {}
    # a dispatch call is a memset and the parent's one scatter kernel, or a
    # memset and this tree's link and fill kernels
    source = root / "src/repro_torch/kernels/csrc/moe_onehot.cu"
    per_call = 3 if "dispatch_link_kernel" in source.read_text() else 2

    rng = np.random.default_rng(SEED)
    for name, (g, t, pe, cap, d) in (("dispatch_prefill", (8, 3072, 72, 60, 2048)),
                                     ("dispatch_decode", (1, 384, 72, 7, 2048))):
        e = torch.from_numpy(rng.integers(0, pe, (g, t)).astype(np.int32)).to(dev)
        s = ops.occurrence_rank(e, pe).to(torch.int32)
        x = torch.from_numpy(rng.standard_normal((g, t, d)).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        library, kept = library_dispatch(e, s, x, pe, cap)
        fn = lambda: dispatch.onehot_dispatch(e, s, x, pe, cap)
        assert torch.equal(fn().view(-1, d), library())
        turns = cuda_ms_turns({"kernel": fn, "library": library}, iters=50)
        out[name] = {"ms": turns["kernel"], "library_ms": turns["library"],
                     "device_ms": device_ms(fn, ("dispatch_", "Memset"), calls=50,
                                            per_call=per_call),
                     "kept": kept}
    return out


def time_flash(dev) -> dict:
    from chip_smoke import cuda_ms_turns, device_ms, flash_bound, flash_inputs
    from repro_torch.kernels import dispatch, ref
    out = {}
    digests = {}
    for name, b, sq, sk, h, kvh, dh, causal, cap in FLASH_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v = flash_inputs(gen, dev, b, sq, sk, h, kvh, dh, torch.float32)
        if name in ("moonshot", "gemma2_cap0"):
            got = dispatch.flash_attention(q, k, v, causal=causal)
            digests[f"flash_{name}_float32"] = hashlib.sha1(
                got.view(torch.int32).cpu().numpy().tobytes()).hexdigest()
        q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
        fn = lambda: dispatch.flash_attention(q16, k16, v16, causal=causal, softcap=cap)
        want = ref.flash_attention(*(x.float() for x in (q16, k16, v16)), causal=causal,
                                   softcap=cap)
        err = float((fn().float() - want).abs().max())
        qt = q16.transpose(1, 2)
        kt, vt = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2) for x in (k16, v16))
        turns = cuda_ms_turns({
            "kernel": fn,
            "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)}, iters=50)
        out[f"flash_{name}"] = {"ms": turns["kernel"], "library_ms": turns["library"],
                                "device_ms": device_ms(fn, FLASH_KERNELS, calls=50),
                                "bound_ms": flash_bound(q16, k16, v16, causal, 0, cap)[0],
                                "max_abs_err": err}
        del q, k, v, q16, k16, v16, qt, kt, vt, want
    torch.cuda.empty_cache()
    out["digests"] = digests
    return out


def plain_o_lse(q, k, v, causal, window, cap):
    """The forward's output (in q's dtype) and row log-sum-exp [B, H, Sq]
    by plain PyTorch in float32, the same bits in either root."""
    from repro_torch.kernels import ref
    b, sq, h, dh = q.shape
    kk = k.float().repeat_interleave(h // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * dh ** -0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    i = torch.arange(sq, device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)
    keep = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    lse = torch.logsumexp(torch.where(keep, s, float("-inf")), dim=-1).contiguous()
    o = ref.flash_attention(q, k, v, causal=causal, window=window, softcap=cap).contiguous()
    return o, lse


def time_bwd(dev) -> tuple[dict, dict]:
    from chip_smoke import (G_BWD, G_BWD_TIMED, cuda_ms_turns, device_ms, flash_inputs,
                            sdpa_flash_bwd)
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    def digest(t):
        return hashlib.sha1(t.contiguous().view(torch.int16 if t.element_size() == 2
                                                else torch.int32).cpu().numpy().tobytes()
                            ).hexdigest()
    out, digests = {}, {}
    for name, b, sq, sk, h, kvh, dh, causal, window, cap, _ in G_BWD:
        if name not in G_BWD_TIMED:
            continue
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v = flash_inputs(gen, dev, b, sq, sk, h, kvh, dh, torch.bfloat16)
        do = torch.randn((b, sq, h, dh), generator=gen, device=dev).to(torch.bfloat16)
        o, lse = plain_o_lse(q, k, v, causal, window, cap)
        opts = {"causal": causal, "window": window, "softcap": cap}
        _, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, **opts)
        digests[f"bwd_{name}_bfloat16_dk"] = digest(dk)
        digests[f"bwd_{name}_bfloat16_dv"] = digest(dv)
        leaves32 = [x.float() for x in (q, k, v)]
        o32, _ = plain_o_lse(*leaves32, causal, window, cap)
        for key, grad in zip(("dq", "dk", "dv"),
                             flash_attention_bwd(*leaves32, o32, do.float(), lse, **opts)):
            digests[f"bwd_{name}_float32_{key}"] = digest(grad)
        fn = lambda: flash_attention_bwd(q, k, v, o, do, lse, **opts)
        turns = cuda_ms_turns({"kernel": fn, "library": sdpa_flash_bwd(q, k, v, do, causal)},
                              iters=20)
        out[f"bwd_{name}"] = {"ms": turns["kernel"], "library_ms": turns["library"],
                              "device_ms": device_ms(fn, BWD_KERNELS, calls=50, per_call=3)}
        del q, k, v, do, o, lse, leaves32, o32
    torch.cuda.empty_cache()
    return out, digests


def time_ssd(dev) -> tuple[dict, str]:
    from chip_smoke import cuda_ms, prefill_batch
    from repro_torch.configs import get
    from repro_torch.models import zoo
    model = zoo.build(get("mamba2-780m"), device=dev)
    params = model.init_params(model.generator(SEED))
    batch = prefill_batch(model.cfg, (4, 1024), dev)
    with torch.no_grad():
        logits = model.prefill_fn(params, batch)
        digest = hashlib.sha1(logits.float().cpu().numpy().tobytes()).hexdigest()
        ms = cuda_ms(lambda: model.prefill_fn(params, batch), iters=10, warmup=2)
    del model, params, logits
    torch.cuda.empty_cache()
    return {"ms": ms}, digest


def time_train(dev) -> tuple[dict, str]:
    from chip_smoke import lm_train_batch, train_steps
    from repro_torch.configs import get
    from repro_torch.models import zoo
    from repro_torch.optim import warmup_cosine
    model = zoo.build(get("mamba2-780m"), device=dev)
    params = model.init_params(model.generator(SEED))
    torch.cuda.reset_peak_memory_stats(dev)     # after the first allocation
    steps = 5
    _, losses, secs, _ = train_steps(model, params, lm_train_batch(model.cfg, (2, 1024), dev),
                                     steps, warmup_cosine(model.cfg.max_lr, 1, steps))
    out = {"ms": 1e3 * sum(secs[1:]) / (steps - 1),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del model, params
    torch.cuda.empty_cache()
    return out, hashlib.sha1(json.dumps(losses).encode()).hexdigest()


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    groups = GROUPS
    if argv[:1] == ["--only"]:
        groups, argv = tuple(argv[1].split(",")), argv[2:]
        if not set(groups) <= set(GROUPS):
            print(f"kernel_turns: --only takes names of {GROUPS}", file=sys.stderr)
            return 2
    if argv[:1] == ["--child"]:
        print(json.dumps(child(Path(argv[1]), groups)))
        return 0
    roots = argv
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    results = {r: [] for r in roots}
    for root in roots + roots[::-1]:
        run = subprocess.run([sys.executable, __file__, "--only", ",".join(groups),
                              "--child", root],
                             capture_output=True, text=True, timeout=600)
        if run.returncode:
            print(run.stdout, run.stderr, file=sys.stderr)
            return 1
        line = run.stdout.strip().splitlines()[-1]
        print("turn", line)
        results[root].append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    def mean(values):
        return None if None in values else float(np.mean(values))

    means = {root: {k: {f: mean([r[k][f] for r in runs]) for f in runs[0][k]}
                    for k in runs[0] if k not in ("root", "digests")}
             for root, runs in results.items()}
    digests = [run["digests"] for runs in results.values() for run in runs]
    print(json.dumps({"mean": means,
                      "identical": {k: all(d[k] == digests[0][k] for d in digests)
                                    for k in digests[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
