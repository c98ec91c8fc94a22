"""Device lists for data-parallel stream sharding.

The port of `deepfilternet_tpu/parallel/mesh.py`. JAX names a device mesh
with axes and lets XLA place the shards; here a `Mesh` is only the ordered
tuple of `torch.device`s that a batch splits over. Dim 0 of a batch splits
into one contiguous chunk per device, in device order; parameters are copied
to every device once. There is no traffic between devices on the hot path,
so no collective is needed. (`batch_sharding` and `replicated`, JAX's
`NamedSharding` helpers, have no torch meaning and are not ported.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree


@dataclass(frozen=True)
class Mesh:
    """The devices a batch splits over, in order (JAX's mesh with its one
    "data" axis)."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def data_parallel_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The first `n_devices` CUDA devices (default: all of them). Raises when
    there is none; a mesh on the CPU is built by hand, e.g.
    `Mesh((torch.device("cpu"),) * 2)`."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is available; build Mesh((torch.device('cpu'), ...)) "
                           "to split over the CPU")
    n = n_devices or count
    if n > count:
        raise ValueError(f"{n} devices asked for, {count} present")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def split_rows(n_rows: int, mesh: Mesh) -> List[slice]:
    """The contiguous slice of dim 0 that each device of `mesh` takes;
    raises ValueError unless the rows divide over the devices."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows must divide over {mesh.size} devices")
    k = n_rows // mesh.size
    return [slice(i * k, (i + 1) * k) for i in range(mesh.size)]


def _to(x, device: torch.device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def shard_batch(batch: Any, mesh: Mesh) -> List[Any]:
    """A batch tree (tensors or numpy arrays) split along dim 0: one tree a
    device, each leaf a contiguous chunk on its device."""
    leaves, spec = pytree.tree_flatten(batch)
    rows = {x.shape[0] for x in leaves}
    if len(rows) != 1:
        raise ValueError(f"leaves disagree on dim 0: {sorted(rows)}")
    parts = split_rows(rows.pop(), mesh)
    return [pytree.tree_unflatten([_to(x[p], d) for x in leaves], spec)
            for p, d in zip(parts, mesh.devices)]


def shard_params(params: Any, mesh: Mesh) -> List[Any]:
    """A parameter tree copied to each device of `mesh` (a leaf already on a
    device is not copied for it)."""
    return [pytree.tree_map(lambda x, d=d: _to(x, d), params) for d in mesh.devices]
