"""The port covers the JAX package's public surface, checked from source.

For every module of ``src/repro`` the port must have the module of the
same path under ``src/repro_torch``, and every public name of the JAX
module must be there too: top-level functions, classes and assignments,
the names a package's ``__init__`` re-exports, each class's public methods
and fields, and each shared function's or method's parameter names.  A
difference the port makes on purpose is on ``ALLOWED`` with its reason.
An entry of ``ALLOWED`` that is no longer a difference (the port gained
the name, or the JAX package lost it) fails too, so the list cannot go
stale.

Both trees are read with ``ast``; neither package is imported.
"""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
JAX, PORT = SRC / "repro", SRC / "repro_torch"


def _params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    a = fn.args
    out = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        out.append("*" + a.vararg.arg)
    if a.kwarg:
        out.append("**" + a.kwarg.arg)
    return out


def _targets(node) -> list[str]:
    """The plain names an assignment binds (not attributes or items)."""
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    out = []
    for t in targets:
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        out += [e.id for e in elts if isinstance(e, ast.Name)]
    return out


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__init__"


def surface(path: Path) -> dict[str, list[str] | None]:
    """Public name -> its parameter names (functions and methods) or None."""
    tree = ast.parse(path.read_text())
    out: dict[str, list[str] | None] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _public(sub.name):
                        out[f"{node.name}.{sub.name}"] = _params(sub)
                elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    for name in _targets(sub):
                        if _public(name):
                            out[f"{node.name}.{name}"] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for name in _targets(node):
                if _public(name):
                    out[name] = None
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            for alias in node.names:
                name = alias.asname or alias.name
                if _public(name):
                    out[name] = None
    return out


def differences(rel: str) -> set[str]:
    """What the port lacks of the JAX module ``rel``: ``rel`` itself (no
    such module), ``rel::name`` (a public name) or ``rel::name(param)``."""
    port = PORT / rel
    if not port.exists():
        return {rel}
    theirs, ours = surface(JAX / rel), surface(port)
    out = set()
    for name, params in theirs.items():
        if name not in ours:
            out.add(f"{rel}::{name}")
        elif params is not None and ours[name] is not None:
            out |= {f"{rel}::{name}({p})" for p in params if p not in ours[name]}
    return out


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _each(module: str, names, params, reason: str) -> dict[str, str]:
    """One entry for each (name, param) pair, all with one reason."""
    return {f"{module}::{n}({p})": reason for n in names for p in params}


DEVICE = ("the tensor's device decides: there is no backend registry, "
          "backend=/use_kernel= switch or Pallas block size (ROADMAP ground rules)")
IN_PLACE = ("the PE updates fold into the carried tensor in place and read its "
            "shape from it; ops.cms_update is the fresh-sketch form")
GENERATOR = "parameters come from a torch.Generator (gen), not a JAX PRNG key"
ALIAS = "a JAX type alias; the port annotates torch.Tensor"
SHAPE = "takes a SHAPES name or a shape dict (shape), not only a name"
CHUNKED = ("attention is one kernel: no sdpa_chunked tiling, q_chunk/kv_chunk "
           "or positions argument (positions are the indices)")
PALLAS = ("Pallas tiling and interpret mode: each CUDA kernel picks its own "
          "tiling, and a CPU tensor takes the plain version")
GSPMD = "GSPMD sharding annotations; the port's shardings are its spec trees"
TUNE_BACKEND = "tune/ has no kernel-backend axis: the device picks the kernel"

ALLOWED: dict[str, str] = {
    # kernels: the device decides
    **_each("kernels/dispatch.py", ["scatter_accumulate", "onehot_dispatch",
                                    "onehot_combine", "flash_attention",
                                    "pe_buffer_update"], ["backend", "**blocks"], DEVICE),
    **_each("kernels/dispatch.py", ["cms_update"], ["backend", "**blocks"], DEVICE),
    **_each("kernels/dispatch.py", ["cms_update"], ["num_pe", "depth", "width"], IN_PLACE),
    **_each("kernels/ref.py", ["cms_update"], ["num_pe", "depth", "width"], IN_PLACE),
    **_each("kernels/ops.py", ["scatter_accumulate", "cms_update", "onehot_dispatch",
                               "onehot_combine", "flash_attention"],
            ["use_kernel", "backend", "**blocks"], DEVICE),
    **{f"kernels/dispatch.py::{n}": DEVICE
       for n in ("JNP", "INTERPRET", "PALLAS", "BACKENDS", "KERNELS", "register",
                 "registered", "use_backend", "default_backend", "resolve", "get_impl")},
    **_each("kernels/route_accumulate.py", ["route_accumulate"],
            ["block_t", "block_bins", "interpret"], PALLAS),
    **_each("kernels/route_accumulate.py", ["route_accumulate"], ["flat_idx", "num_bins"],
            "the kernel folds into the carried [num_pe, local] buffers in place at "
            "(eff, idx); ops.scatter_accumulate is the flat form"),
    **_each("kernels/cms_update.py", ["cms_update"], ["block_t", "block_w", "interpret"],
            PALLAS),
    **_each("kernels/cms_update.py", ["cms_update"], ["num_pe", "depth", "width"], IN_PLACE),
    **_each("kernels/moe_onehot.py", ["onehot_dispatch", "onehot_combine"],
            ["block_t", "block_pc", "block_d", "interpret"], PALLAS),
    **_each("kernels/flash_attention.py", ["flash_attention"],
            ["block_q", "block_k", "interpret"], PALLAS),
    "core/executor.py::default_pe_update(backend)": DEVICE,
    "core/executor.py::make_executor(kernel_backend)": DEVICE,
    "core/executor.py::make_resumable_executor(kernel_backend)": DEVICE,
    "core/framework.py::Ditto.__init__(kernel_backend)": DEVICE,
    "apps/hhd.py::make_spec(kernel_backend)": DEVICE,
    "serve/engine.py::StreamEngine.__init__(kernel_backend)": DEVICE,
    "serve/session.py::SessionEngine.__init__(kernel_backend)": DEVICE,
    "core/framework.py::Ditto.tune(backends)": TUNE_BACKEND,
    "tune/space.py::Candidate.kernel_backend": TUNE_BACKEND,
    "tune/space.py::SearchSpace.backends": TUNE_BACKEND,
    "tune/space.py::default_space(backends)": TUNE_BACKEND,
    "tune/tuner.py::TunedPlan.kernel_backend": TUNE_BACKEND,
    # no jit
    "core/executor.py::ResumableExecutor.scan_chunks":
        "no jit: run_chunks is both the traced scan and the eager loop",
    "core/executor.py::ResumableExecutor.merge_state_raw":
        "no jit: merge_state is already the un-jitted snapshot",
    # type aliases
    "core/executor.py::Array": ALIAS,
    "core/profiler.py::Array": ALIAS,
    "core/router.py::Array": ALIAS,
    "core/types.py::Array": ALIAS,
    "models/layers.py::Params": ALIAS,
    # random parameters from a generator
    **{f"{m}::{f}(key)": GENERATOR for m, f in (
        ("models/attention.py", "attn_params"), ("models/frontends.py", "random_frames"),
        ("models/frontends.py", "random_patches"), ("models/layers.py", "truncnorm"),
        ("models/layers.py", "dense_params"), ("models/layers.py", "embed_params"),
        ("models/layers.py", "mlp_params"), ("models/mamba2.py", "mamba2_params"),
        ("models/mla.py", "mla_params"), ("models/moe.py", "moe_params"),
        ("models/transformer.py", "period_params"), ("models/transformer.py", "init_params"),
        ("models/whisper.py", "init_params"), ("train/state.py", "init_train_state"))},
    "serve/engine.py::decode_tokens(key)": GENERATOR,
    "models/moe.py::moe_apply(router_noise_key)":
        "no router noise: the router is deterministic (its JAX default, None)",
    "models/moe.py::moe_apply(impl)": "one realization of the pack and unpack (the "
                                      "MoE kernels on the card), so no impl switch",
    # attention
    "models/attention.py::sdpa_chunked": CHUNKED,
    "models/attention.py::attention(positions)": CHUNKED,
    "models/attention.py::attention(q_chunk)": CHUNKED,
    "models/attention.py::attention(kv_chunk)": CHUNKED,
    "models/attention.py::attention_decode(kv_chunk)": CHUNKED,
    "models/mla.py::mla_attention(positions)": CHUNKED,
    "models/mla.py::mla_attention(q_chunk)": CHUNKED,
    "models/mla.py::mla_attention(kv_chunk)": CHUNKED,
    "configs/base.py::ArchConfig.q_chunk": CHUNKED,
    "configs/base.py::ArchConfig.kv_chunk": CHUNKED,
    "configs/base.py::ArchConfig.moe_impl": "one realization of the MoE pack and "
                                            "unpack, so no impl switch",
    # GSPMD and XLA
    "models/layers.py::anchor": GSPMD,
    "models/layers.py::mesh_axes": GSPMD,
    "models/transformer.py::shard_logits": GSPMD,
    "models/transformer.py::LayerCache": "unused in the JAX package; the caches are dicts",
    "models/transformer.py::LayerCache.kv": "unused in the JAX package; the caches are dicts",
    "models/transformer.py::LayerCache.length": "unused in the JAX package; the caches "
                                                "are dicts",
    "checkpoint/ckpt.py::restore_pytree(shardings)": "restores onto device=, not XLA "
                                                     "Shardings",
    "checkpoint/ckpt.py::CheckpointManager.restore(shardings)": "restores onto device=, "
                                                                "not XLA Shardings",
    "launch/analysis.py::parse_collectives": "HLO parsing: the port derives collectives "
                                             "from the spec trees",
    "launch/analysis.py::extract_cost": "HLO parsing: the port's FLOPs come from "
                                        "launch/costmodel.py",
    "launch/analysis.py::extract_memory(compiled)": "no compiled XLA program: bytes are "
                                                    "summed from the argument shardings",
    "launch/mesh.py::V5E": "TPU v5e constants; the port's Hardware is the H100",
    "launch/mesh.py::Hardware.ici_bw": "TPU ICI; the H100's links are link_bw and nvlink_bw",
    "launch/dryrun.py::build_cell(shape_name)": SHAPE,
    "launch/dryrun.py::run_cell(shape_name)": SHAPE,
    "launch/costmodel.py::cell_flops(shape_name)": SHAPE,
    "launch/costmodel.py::cell_bytes(shape_name)": SHAPE,
    "models/zoo.py::input_specs(shape_name)": SHAPE,
    "models/zoo.py::batch_pspec(shape_name)": SHAPE,
    "models/zoo.py::model_flops(shape_name)": SHAPE,
}


@pytest.mark.parametrize("module", MODULES)
def test_module_has_its_counterpart(module):
    missing = sorted(differences(module) - ALLOWED.keys())
    assert not missing, f"the port lacks, with no reason on ALLOWED: {missing}"


def test_allow_list_is_not_stale():
    stale = sorted(ALLOWED.keys() - set().union(*map(differences, MODULES)))
    assert not stale, f"ALLOWED entries that are no longer differences: {stale}"


def test_every_allowed_difference_has_a_reason():
    assert all(isinstance(r, str) and r.strip() for r in ALLOWED.values())


def test_a_new_gap_is_found(tmp_path, monkeypatch):
    """A public name, parameter or module the port drops is a difference."""
    for root, body in ((tmp_path / "j", "def f(a, b):\n    pass\nX = 1\n"),
                       (tmp_path / "p", "def f(a):\n    pass\n")):
        root.mkdir()
        (root / "m.py").write_text(body)
    (tmp_path / "j" / "only.py").write_text("")
    monkeypatch.setitem(globals(), "JAX", tmp_path / "j")
    monkeypatch.setitem(globals(), "PORT", tmp_path / "p")
    assert differences("m.py") == {"m.py::f(b)", "m.py::X"}
    assert differences("only.py") == {"only.py"}
