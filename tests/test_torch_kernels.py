"""Parity of the port's kernel layer (``repro_torch.kernels``) with the JAX
package's kernels.

On the CPU the port's dispatch takes the plain PyTorch versions; they are
held against ``repro.kernels.dispatch`` with ``backend="jnp"`` on the
shapes of tests/test_kernels.py, and against the Pallas kernels in
interpret mode on one tiny non-negative case.  Integer results must match
bit for bit; float sums use allclose(rtol=1e-6) because index_add_ and
XLA's scatter add in different orders.  The CUDA kernels themselves are
held against these plain versions in tests/test_torch_cuda.py, on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro_torch.kernels import dispatch
from repro_torch.kernels.cms_update import cms_update as cms_cuda
from repro_torch.kernels.route_accumulate import route_accumulate as route_cuda

ROUTE_SHAPES = [(64, 96), (1000, 512), (4096, 2000), (257, 128), (8, 4096)]
CMS_SHAPES = [(512, 8, 4, 256), (100, 4, 2, 128), (2048, 16, 3, 512), (7, 2, 1, 128)]
DTYPES = {"int32": torch.int32, "float32": torch.float32}


def _assert_match(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:   # summation order differs between index_add_ and XLA's scatter
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _values(rng, n, dtype, signed=True):
    if dtype == "int32":
        lo = -100 if signed else 0
        return rng.integers(lo, 100, n).astype(np.int32)
    v = rng.standard_normal(n) if signed else rng.random(n)
    return v.astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("combine", ["add", "max"])
@pytest.mark.parametrize("t,bins", ROUTE_SHAPES)
def test_scatter_accumulate_vs_jnp(t, bins, combine, dtype):
    rng = np.random.default_rng(t * 7919 + bins)
    idx = rng.integers(-1, bins + 2, t).astype(np.int32)   # -1 and >= bins dropped
    val = _values(rng, t, dtype)
    got = dispatch.scatter_accumulate(torch.from_numpy(idx), torch.from_numpy(val),
                                      bins, combine)
    want = jdispatch.scatter_accumulate(jnp.asarray(idx), jnp.asarray(val), bins,
                                        combine, backend="jnp")
    _assert_match(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("combine", ["add", "max"])
def test_pe_buffer_update_vs_jnp(combine, dtype):
    """Carried buffers with negative values, -1 padding and the masked
    sentinel eff = num_pe: the fold into the carried state is exact."""
    rng = np.random.default_rng(5)
    num_pe, local, t = 7, 33, 1500
    buffers = _values(rng, num_pe * local, dtype).reshape(num_pe, local)
    eff = rng.integers(-1, num_pe + 1, t).astype(np.int32)
    idx = rng.integers(-1, local + 1, t).astype(np.int32)
    val = _values(rng, t, dtype)
    got = dispatch.pe_buffer_update(torch.from_numpy(buffers.copy()),
                                    torch.from_numpy(eff), torch.from_numpy(idx),
                                    torch.from_numpy(val), combine)
    want = jdispatch.pe_buffer_update(jnp.asarray(buffers), jnp.asarray(eff),
                                      jnp.asarray(idx), jnp.asarray(val),
                                      combine, backend="jnp")
    _assert_match(got.numpy(), want)


def test_pe_buffer_update_folds_in_place():
    buffers = torch.zeros((2, 4), dtype=torch.int32)
    out = dispatch.pe_buffer_update(buffers, torch.tensor([1, 1, 2]),
                                    torch.tensor([3, 3, 0]),
                                    torch.tensor([5, 6, 7]), "add")
    assert out is buffers
    assert buffers.tolist() == [[0, 0, 0, 0], [0, 0, 0, 11]]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,pe,d,w", CMS_SHAPES)
def test_cms_update_vs_jnp(t, pe, d, w, dtype):
    rng = np.random.default_rng(t * 31 + pe * 7 + d)
    eff = rng.integers(-1, pe + 1, t).astype(np.int32)   # -1 and the sentinel pe
    cols = rng.integers(0, w, (t, d)).astype(np.int32)
    val = _values(rng, t, dtype, signed=False)
    sketch = torch.zeros((pe, d, w), dtype=DTYPES[dtype])
    got = dispatch.cms_update(sketch, torch.from_numpy(eff), torch.from_numpy(cols),
                              torch.from_numpy(val))
    want = jdispatch.cms_update(jnp.asarray(eff), jnp.asarray(cols),
                                jnp.asarray(val), pe, d, w, backend="jnp")
    _assert_match(got.numpy(), want)


def test_plain_versions_vs_pallas_interpret():
    """One tiny non-negative case against the Pallas kernel bodies (whose
    ``max`` is exact only on non-negative data)."""
    rng = np.random.default_rng(11)
    idx = rng.integers(-1, 96, 64).astype(np.int32)
    val = rng.integers(0, 50, 64).astype(np.int32)
    for combine in ("add", "max"):
        got = dispatch.scatter_accumulate(torch.from_numpy(idx),
                                          torch.from_numpy(val), 96, combine)
        want = jdispatch.scatter_accumulate(jnp.asarray(idx), jnp.asarray(val), 96,
                                            combine, backend="interpret")
        _assert_match(got.numpy(), want)
    eff = rng.integers(0, 3, 7).astype(np.int32)     # includes the sentinel 2
    cols = rng.integers(0, 128, (7, 1)).astype(np.int32)
    one = np.ones(7, np.int32)
    got = dispatch.cms_update(torch.zeros((2, 1, 128), dtype=torch.int32),
                              torch.from_numpy(eff), torch.from_numpy(cols),
                              torch.from_numpy(one))
    want = jdispatch.cms_update(jnp.asarray(eff), jnp.asarray(cols),
                                jnp.asarray(one), 2, 1, 128, backend="interpret")
    _assert_match(got.numpy(), want)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never take a CPU tensor: the dispatch layer is
    what picks the plain version there."""
    buf = torch.zeros((2, 4), dtype=torch.int32)
    i = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        route_cuda(buf, i, i, i, "add")
    with pytest.raises(ValueError, match="CUDA"):
        cms_cuda(torch.zeros((2, 1, 4), dtype=torch.int32), i, i[:, None], i)


def test_dispatch_rejects_other_devices():
    buf = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    i = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel realization"):
        dispatch.pe_buffer_update(buf, i, i, i, "add")


def test_new_cuda_wrappers_refuse_cpu_tensors():
    """The MoE and attention kernel wrappers raise on CPU tensors too."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_onehot import onehot_combine, onehot_dispatch
    i = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        onehot_dispatch(i, i, torch.zeros((1, 3, 8)), 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        onehot_combine(i, i, torch.zeros((1, 2, 4, 8)))
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)


def test_cuda_branch_of_dispatch_calls_only_kernels(monkeypatch):
    """Routing of ``dispatch`` for a tensor it takes as CUDA: every entry
    point calls its kernel wrapper, and no plain version (each one here
    raises).  The card test of the same rule is in test_torch_cuda.py."""
    from repro_torch.kernels import ref
    called = []

    def kernel(name):
        def run(*args, **kwargs):
            called.append(name)
            return args[0]
        return run

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA branch reached a plain version")

    monkeypatch.setattr(dispatch, "_on_cuda", lambda t: True)
    for name in ("_route_cuda", "_cms_cuda", "_dispatch_cuda", "_combine_cuda",
                 "_flash_cuda"):
        monkeypatch.setattr(dispatch, name, kernel(name))
    for name in ("pe_buffer_update", "cms_update", "onehot_dispatch",
                 "onehot_combine", "flash_attention"):
        monkeypatch.setattr(ref, name, refuse)
    i = torch.zeros((1, 3), dtype=torch.int32)
    x = torch.zeros((1, 3, 8))
    dispatch.pe_buffer_update(torch.zeros((2, 4)), i[0], i[0], x[0, :, 0], "add")
    dispatch.cms_update(torch.zeros((2, 1, 4)), i[0], i[0][:, None], x[0, :, 0])
    dispatch.onehot_dispatch(i, i, x, 2, 4)
    dispatch.onehot_combine(i, i, torch.zeros((1, 2, 4, 8)), x[..., 0])
    dispatch.flash_attention(x[:, :, None], x[:, :, None], x[:, :, None])
    assert called == ["_route_cuda", "_cms_cuda", "_dispatch_cuda", "_combine_cuda",
                      "_flash_cuda"]


@pytest.mark.parametrize("entry", ["pe_buffer_update", "cms_update"])
def test_cuda_branch_of_pe_updates_passes_tensors_through(monkeypatch, entry):
    """On the card the two PE updates hand the caller's tensors to the
    kernel wrapper as they are (no dtype or layout conversion): the
    wrapper's checks are the only ones."""
    seen = []
    monkeypatch.setattr(dispatch, "_on_cuda", lambda t: True)
    for name in ("_route_cuda", "_cms_cuda"):
        monkeypatch.setattr(dispatch, name, lambda *args: seen.append(args) or args[0])
    eff = torch.zeros(3, dtype=torch.int64)          # int64: passed, not converted
    value = torch.ones(6)[::2]                        # strided: passed, not copied
    if entry == "pe_buffer_update":
        args = (torch.zeros((2, 4), dtype=torch.int32), eff, eff, value)
        dispatch.pe_buffer_update(*args, "max")
        assert seen[0][4] == "max"
    else:
        args = (torch.zeros((2, 1, 4), dtype=torch.int32), eff, eff[:, None], value)
        dispatch.cms_update(*args)
    assert len(seen) == 1 and all(a is b for a, b in zip(seen[0], args))


def test_scatter_accumulate_casts_indices_without_wrapping(monkeypatch):
    """On the card scatter_accumulate hands the kernel int32 indices; an
    int64 index outside [0, num_bins) becomes -1 first, so none wraps into
    range (2**32 + 5 would cast to 5)."""
    seen = []
    monkeypatch.setattr(dispatch, "_on_cuda", lambda t: True)
    monkeypatch.setattr(dispatch, "_route_cuda",
                        lambda *args: seen.append(args) or args[0])
    flat = torch.tensor([0, 5, 2**32 + 5, -3, 96, 95])
    dispatch.scatter_accumulate(flat, torch.ones(6), 96)
    (_, eff, idx, value, combine), = seen
    assert idx.dtype == torch.int32 and idx.is_contiguous()
    assert idx.tolist() == [0, 5, -1, -1, -1, 95]
    assert eff.tolist() == [0] * 6 and combine == "add"


def test_build_names_each_library_by_its_source_and_every_header(tmp_path, monkeypatch):
    """A library's file name hashes its source, every header under csrc/
    and the flags, so an edited header is never served from a stale
    library."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.h"\n')
    (tmp_path / "common.h").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("not a header\n")
    names = [_build._target("k")[1].name]
    (tmp_path / "common.h").write_text("// v2\n")
    names.append(_build._target("k")[1].name)
    (tmp_path / "more.cuh").write_text("// new\n")
    names.append(_build._target("k")[1].name)
    (tmp_path / "notes.txt").write_text("edited\n")
    names.append(_build._target("k")[1].name)
    (tmp_path / "k.cu").write_text('#include "common.h"\n// edited\n')
    names.append(_build._target("k")[1].name)
    assert all(n.startswith("libk-") and n.endswith(".so") for n in names)
    assert len(set(names)) == 4 and names[2] == names[3]


def _chip_smoke():
    """chip_smoke.py as a module (it imports torch and numpy at the top and
    nothing of the card until a phase runs)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flash_model_shapes():
    """(name, B, Sq, Sk, H, KV, dh) of every flash call a model makes on the
    card's main paths: chip_smoke's E_FLASH (gemma2, MLA, Jamba, phi-3),
    F_FLASH (whisper's encoder and cross-attention) and G_BWD (training),
    and moonshot's and llama3.2-3b's prefill."""
    smoke = _chip_smoke()
    shapes = [("moonshot", 4, 1024, 1024, 16, 16, 128),
              ("llama3.2-3b", 1, 1024, 1024, 24, 8, 128)]
    shapes += [(f"E_{n}", b, s, s, h, kv, dh) for n, b, s, h, kv, dh, *_ in smoke.E_FLASH]
    shapes += [(f"F_{n}", b, sq, sk, h, kv, dh)
               for n, b, sq, sk, h, kv, dh, _ in smoke.F_FLASH]
    shapes += [(f"G_{n}", b, sq, sk, h, kv, dh)
               for n, b, sq, sk, h, kv, dh, *_ in smoke.G_BWD]
    return shapes


FLASH_MODEL_SHAPES = _flash_model_shapes()


@pytest.mark.parametrize("name,b,sq,sk,h,kv,dh", FLASH_MODEL_SHAPES,
                         ids=[s[0] for s in FLASH_MODEL_SHAPES])
def test_tma_operands_leave_every_model_shape_as_it_is(name, b, sq, sk, h, kv, dh):
    """``tma_operands`` reads dh and data_ptr() % 16 alone, so it runs here
    on CPU tensors: at every model shape (phi-3's 96, MLA's 192 among them)
    the bf16 kernel reads q, k and v themselves, with no pad and no copy."""
    from repro_torch.kernels.flash_attention import tma_operands
    q = torch.empty((b, sq, h, dh), dtype=torch.bfloat16)
    k, v = (torch.empty((b, sk, kv, dh), dtype=torch.bfloat16) for _ in range(2))
    got = tma_operands(q, k, v)
    assert all(g is t for g, t in zip(got, (q, k, v)))


@pytest.mark.parametrize("dh,want", [(50, 56), (100, 104), (96, 96), (192, 192),
                                     (202, 208), (200, 200), (8, 8), (1, 8),
                                     (255, 256), (256, 256)])
def test_tma_operands_pad_head_dim(dh, want):
    """dh not a multiple of 8 gives strides TMA cannot take: q, k and v are
    zero-padded to the next multiple of 8, the values kept, so q . k and
    the output's first dh columns are unchanged."""
    from repro_torch.kernels.flash_attention import tma_operands
    gen = torch.Generator().manual_seed(dh)
    q = torch.randn((1, 16, 4, dh), generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((1, 24, 2, dh), generator=gen).to(torch.bfloat16) for _ in range(2))
    got = tma_operands(q, k, v)
    for g, t in zip(got, (q, k, v)):
        assert g.shape == (*t.shape[:-1], want) and g.is_contiguous()
        assert g.data_ptr() % 16 == 0
        assert torch.equal(g[..., :dh], t) and not g[..., dh:].any()
    if want == dh:
        assert all(g is t for g, t in zip(got, (q, k, v)))


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_tma_operands_copy_a_misaligned_base(which):
    """A base one element past a 16-byte boundary, in any of q, k and v, is
    copied to an aligned tensor of the same values; the aligned ones are
    passed through."""
    from repro_torch.kernels.flash_attention import tma_operands
    shape = (1, 64, 4, 128)
    n = int(np.prod(shape))
    tensors = {}
    for name in ("q", "k", "v"):
        buf = torch.arange(n + 8, dtype=torch.float32).to(torch.bfloat16)
        start = (-buf.data_ptr() // 2) % 8 + (1 if name == which else 0)
        tensors[name] = buf[start:start + n].view(shape)
    assert [tensors[x].data_ptr() % 16 == 0 for x in "qkv"] == [x != which for x in "qkv"]
    got = dict(zip("qkv", tma_operands(**tensors)))
    for x in "qkv":
        assert got[x].data_ptr() % 16 == 0 and got[x].is_contiguous()
        assert torch.equal(got[x], tensors[x])
        assert (got[x] is tensors[x]) == (x != which)
