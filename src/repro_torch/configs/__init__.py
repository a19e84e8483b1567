"""Architecture configs the port runs.  ``get(name)`` -> CONFIG (full
size), ``get_reduced(name)`` -> REDUCED (CPU scale).  The JAX package has
ten; the port has the ones its model code covers (ROADMAP.md lists the
rest)."""
from __future__ import annotations

import importlib

ARCH_IDS = ["moonshot_v1_16b_a3b"]

ALIASES = {"moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b"}


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
