"""Cell applicability rules shared by dryrun.py and the tests, importable
without a process group."""
from __future__ import annotations


def cell_skip_reason(cfg, shape_name: str):
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("long_500k needs sub-quadratic attention; "
                f"{cfg.name} is full-attention (DESIGN.md §5)")
    return None
