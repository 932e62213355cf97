"""The data x gauss mesh of ranks.

Port of the JAX package's `parallel/mesh.py`. Axes:

* `data`  - cameras: each data row renders and differentiates its own training
  image of the batch; the per-image gradients are gathered over `data`.
* `gauss` - pool rows: the Gaussian parameters and Adam moments are sharded
  over `gauss`, the render exchanges per-Gaussian records by tile-band owner.

Rank r is mesh cell (r // gauss, r % gauss), the order of JAX's
`np.asarray(devices).reshape(data, gauss)`, so gauss shard g holds pool rows
[g n / G, (g + 1) n / G).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from .multihost import local_device


class Mesh(NamedTuple):
    data: int
    gauss: int
    d: int                # this rank's data row
    g: int                # this rank's gauss column
    device: torch.device
    gauss_group: object   # the ranks of this data row (size `gauss`)
    data_group: object    # the ranks of this gauss column (size `data`)


def make_mesh(data: int = 1, gauss: int = 1, device="cuda") -> Mesh:
    """The mesh over the default process group, whose world size must be
    data * gauss. Every rank creates every subgroup, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError(f"mesh data={data} x gauss={gauss} needs a process group "
                           f"of {data * gauss} ranks; none is running")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != data * gauss:
        raise RuntimeError(f"mesh data={data} x gauss={gauss} needs {data * gauss} ranks, "
                           f"the process group has {world}")
    d, g = divmod(rank, gauss)
    gauss_group = data_group = None
    for row in range(data):
        grp = dist.new_group([row * gauss + c for c in range(gauss)])
        if row == d:
            gauss_group = grp
    for col in range(gauss):
        grp = dist.new_group([r * gauss + col for r in range(data)])
        if col == g:
            data_group = grp
    return Mesh(data, gauss, d, g, local_device(device), gauss_group, data_group)
