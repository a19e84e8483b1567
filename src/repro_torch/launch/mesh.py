"""Production meshes and the NVIDIA H100's roofline constants.

``make_production_mesh`` is a FUNCTION (never a module-level constant):
it needs an initialised process group of at least the mesh's size, which
only the dry run makes -- a ``fake`` one in its own process
(``launch/dryrun.py``), so one host builds a 256- or 512-rank mesh.  The
'model' axis spans one HGX node's 8 NVLink-connected cards; 'data' and
'pod' cross the nodes' network.
"""
from __future__ import annotations

import dataclasses

SINGLE = ((32, 8), ("data", "model"))                   # 256 cards, 32 nodes
MULTI = ((2, 32, 8), ("pod", "data", "model"))          # 512 cards, 2 x 32 nodes


def make_production_mesh(*, multi_pod: bool = False):
    shape, names = MULTI if multi_pod else SINGLE
    return _mesh(shape, names)


def make_host_mesh(data: int = 1, model: int = 1):
    """A ("data", "model") mesh over the first data * model ranks of the
    process group."""
    return _mesh((data, model), ("data", "model"))


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-card roofline constants: NVIDIA H100 80GB HBM3 (SXM5), 700 W, as
    ``nvidia-smi`` names the card, from NVIDIA's data sheet.  ``link_bw`` is
    what a collective over the 'data' or 'pod' axis crosses: one 400 Gb/s
    NDR InfiniBand NIC a card, 50e9 B/s.  The ``nvlink_axes`` ('model')
    stay inside a node on NVLink 4, ``nvlink_bw`` = 450e9 B/s a direction
    a card; a collective that crosses any other axis runs at ``link_bw``."""
    name: str = "NVIDIA H100 80GB HBM3 (SXM5), 700 W"
    peak_flops: float = 989.4e12     # bf16 dense FLOP/s
    hbm_bw: float = 3.35e12          # bytes/s
    link_bw: float = 50e9            # bytes/s a card across nodes
    hbm_bytes: float = 80e9          # capacity
    nvlink_bw: float = 450e9         # bytes/s a card inside a node
    nvlink_axes: tuple = ("model",)

    def on_nvlink(self, axes) -> bool:
        """Whether a collective over the mesh ``axes`` stays on NVLink."""
        return bool(axes) and all(a in self.nvlink_axes for a in axes)


H100 = Hardware()
