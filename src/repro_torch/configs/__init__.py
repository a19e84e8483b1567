"""Architecture configs the port runs.  ``get(name)`` -> CONFIG (full
size), ``get_reduced(name)`` -> REDUCED (CPU scale).  The JAX package's
ten: dense, MoE, MLA, SSM, hybrid, VLM and the encoder-decoder
whisper-base."""
from __future__ import annotations

import importlib

ARCH_IDS = ["whisper_base", "llama3_2_3b", "starcoder2_15b", "gemma2_2b", "yi_6b",
            "phi3_vision_4_2b", "deepseek_v2_lite_16b", "moonshot_v1_16b_a3b",
            "mamba2_780m", "jamba_1_5_large_398b"]

# CLI/--arch aliases (the dashed ids)
ALIASES = {
    "whisper-base": "whisper_base",
    "llama3.2-3b": "llama3_2_3b",
    "starcoder2-15b": "starcoder2_15b",
    "gemma2-2b": "gemma2_2b",
    "yi-6b": "yi_6b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mamba2-780m": "mamba2_780m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def resolve(name: str) -> str:
    arch = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"{name}: the port has no config for this architecture yet "
            f"(ROADMAP.md §1); it has {ARCH_IDS}")
    return arch


def get(name: str):
    return importlib.import_module(f"repro_torch.configs.{resolve(name)}").CONFIG


def get_reduced(name: str):
    return importlib.import_module(f"repro_torch.configs.{resolve(name)}").REDUCED
