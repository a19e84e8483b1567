"""The port's architecture configs and its serve CLI, on the CPU.

Each of the port's configs, all ten of the JAX package's, CONFIG and
REDUCED, equals the JAX package's on every field the port's ``ArchConfig``
has, and its derived SSM widths too; the registry resolves the dashed
names of every one (whisper-base included), and ``zoo.build`` builds the
encoder-decoder family; and ``python -m repro_torch.launch.serve --device
cpu`` with the default arch (llama3.2-3b, the JAX CLI's default), and with
each of the SSM, hybrid and VLM configs, serves every request.
"""
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import configs as jconfigs
from repro_torch import configs

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_config_equals_jax(arch, which):
    got = getattr(importlib.import_module(f"repro_torch.configs.{arch}"), which)
    want = getattr(importlib.import_module(f"repro.configs.{arch}"), which)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.cdtype.itemsize == want.cdtype.itemsize
    assert (got.d_inner, got.ssm_heads) == (want.d_inner, want.ssm_heads)


def test_registry_resolves_the_jax_aliases():
    for alias, arch in jconfigs.ALIASES.items():
        if arch in configs.ARCH_IDS:
            assert configs.resolve(alias) == arch
            assert configs.get(alias) == importlib.import_module(
                f"repro_torch.configs.{arch}").CONFIG
        else:
            with pytest.raises(NotImplementedError, match="no config"):
                configs.get_reduced(alias)


def test_registry_leaves_only_whisper_unported():
    """Since whisper-base's port no config is left unported: the registry
    has all ten of the JAX package's, whisper-base among them."""
    missing = [a for a in jconfigs.ARCH_IDS if a not in configs.ARCH_IDS]
    assert missing == []
    assert sorted(configs.ARCH_IDS) == sorted(jconfigs.ARCH_IDS)
    assert configs.get("whisper-base").family == "encdec"
    with pytest.raises(NotImplementedError, match="no config"):
        configs.get("whisper-tiny")


def test_zoo_refuses_the_encdec_family():
    """The zoo no longer refuses the encoder-decoder family: an ``encdec``
    config builds the whisper model (its cache takes an encoder memory)."""
    import inspect
    from repro_torch.models import zoo
    cfg = configs.get_reduced("whisper-base")
    model = zoo.build(cfg, device="cpu")
    assert "memory" in inspect.signature(model.init_cache).parameters
    params = model.init_params(model.generator(0))
    assert set(params) == {"embed", "pos_dec", "encoder", "enc_norm", "decoder",
                           "dec_norm"}


def test_serve_cli_default_arch_serves_every_request():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served 8 requests / 128 tokens" in proc.stdout, proc.stdout


def test_serve_cli_default_arch_is_llama(monkeypatch, capsys):
    from repro_torch.launch import serve
    asked = []
    real = serve.get_reduced
    monkeypatch.setattr(serve, "get_reduced", lambda name: asked.append(name) or real(name))
    serve.main(["--device", "cpu", "--requests", "1", "--max-new", "2"])
    assert asked == ["llama3.2-3b"]
    assert "served 1 requests / 2 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b",
                                  "phi-3-vision-4.2b"])
def test_serve_cli_serves_every_request(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", arch])
    assert "served 8 requests / 128 tokens" in capsys.readouterr().out
