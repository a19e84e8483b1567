"""Paper applications of this slice (Table I): HISTO, HLL and HHD, each a
``DittoSpec``."""
from repro_torch.apps import hhd, histo, hll

__all__ = ["histo", "hll", "hhd"]
