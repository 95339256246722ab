"""The device grid of the large tier's two parallel axes.

Counterpart of `sharp_tpu/parallel/mesh.py`. The axes replace the
reference's fork pool (R/SHARP.R:167, `foreach(k) %:% foreach(t)`):

  * "data": the cell folds (the reference's T axis), a contiguous slice of
    the folds per shard;
  * "ens": the K ensemble members (the reference's K axis), a contiguous
    group of members per shard, when devices outnumber what the folds need.

A `Mesh` is an (n_data, n_ens) grid of `torch.device`; the work of each
entry runs on its own host thread (`parallel/sharded.py`). Every fold and
every member is computed as if alone, so the labels do not depend on the
grid. The RP matrices are drawn once and copied to each device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from sharp_tpu_torch.utils.timers import log


class Mesh:
    """An (n_data, n_ens) grid of devices: `devices[d][e]` runs data shard d,
    ens shard e. A device may appear more than once (shards that share a
    card, or the CPU)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices: List[List[torch.device]] = [[torch.device(x) for x in row] for row in devices]
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh is a non-empty grid of devices, every row as long")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "ens": len(self.devices[0])}

    def flat(self) -> List[torch.device]:
        """Every entry of the grid, data-major."""
        return [d for row in self.devices for d in row]


def make_mesh(
    n_data: Optional[int] = None,
    n_ens: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """An ("data", "ens") mesh over `devices` (default: every CUDA card),
    data-major, with the JAX function's checks. With no `devices` and no
    card it raises, as a CUDA request does (`api.resolve_device`): a mesh
    on the CPU names its devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every CUDA card, but torch.cuda.is_available() is False; "
                "pass devices=[torch.device('cpu'), ...] for a mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    nd = len(devices)
    if n_data is None:
        n_data = nd // n_ens
    if n_data < 1 or n_ens < 1 or n_data * n_ens > nd:
        raise ValueError(f"mesh {n_data}x{n_ens} needs {n_data * n_ens} devices, have {nd}")
    return Mesh([devices[d * n_ens : (d + 1) * n_ens] for d in range(n_data)])


def mesh_devices(n: int, device) -> List[torch.device]:
    """The n shards' devices for a run on `device`: n entries of the CPU, or
    shard d on card (first + d) % device_count(), `first` being the card
    `device` names (0 for a bare "cuda"). Shards that outnumber the cards
    share them, which the labels do not see; that is logged once."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    count = torch.cuda.device_count()
    first = dev.index or 0
    if n > count:
        log(f"{n} shards on {count} card(s): shards share cards")
    return [torch.device("cuda", (first + d) % count) for d in range(n)]


def resolve_mesh(cfg, device) -> Optional[Mesh]:
    """Mesh for cfg.n_devices shards on `device`, or None for one device.

    The "ens" axis is carved out when cfg.ensemble_axis > 1; it must divide
    both ensize_K and n_devices, or the call is refused (the JAX package's
    rule). Unlike the JAX package, which falls back to one device when
    fewer are visible, shards wrap around the visible cards
    (`mesh_devices`) and the split still runs.
    """
    if cfg.n_devices <= 1:
        return None
    n_ens = 1
    if cfg.ensemble_axis > 1:
        if cfg.ensize_K % cfg.ensemble_axis or cfg.n_devices % cfg.ensemble_axis:
            raise ValueError(
                f"ensemble_axis={cfg.ensemble_axis} must divide both "
                f"ensize_K={cfg.ensize_K} and n_devices={cfg.n_devices}"
            )
        n_ens = cfg.ensemble_axis
    return make_mesh(n_data=cfg.n_devices // n_ens, n_ens=n_ens,
                     devices=mesh_devices(cfg.n_devices, device))
