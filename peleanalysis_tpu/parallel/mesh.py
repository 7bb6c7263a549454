"""Device-mesh sharding for the batched AMR model.

The reference distributes boxes over MPI ranks via DistributionMapping and
communicates with MPI point-to-point/collectives (SURVEY.md §2.7).  Here the
box axis of every batched level array is sharded over a 1-D ``jax.sharding``
mesh; the ghost-fill gather reads across box shards, and XLA lowers that to
all-gather/collective-permute between devices — no hand-written
communication.

Levels whose box count is not divisible by the mesh size are padded with
clone boxes (gathers never *write*, so padded boxes are inert; outputs are
cropped on unbatching).
"""
from __future__ import annotations

from typing import List, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BOX_AXIS = "boxes"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (BOX_AXIS,))


def box_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BOX_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_boxes_to(n: int, m: int) -> int:
    """Smallest multiple of m >= n."""
    return ((n + m - 1) // m) * m


def shard_state(state, mesh: Mesh):
    """Lay out each level's batched array with the box axis sharded.

    Pads nbox to a multiple of the mesh size by repeating box 0 (inert:
    fill plans never index into pad boxes because owner arrays only know
    real boxes; pad rows are cropped by to_plotfile's unbatching).
    """
    ndev = mesh.devices.size
    sh = box_sharding(mesh)
    new_data = []
    for lev, arr in enumerate(state.data):
        nbox = arr.shape[0]
        target = pad_boxes_to(nbox, ndev)
        if target != nbox:
            pad = jax.numpy.broadcast_to(arr[:1],
                                         (target - nbox,) + arr.shape[1:])
            arr = jax.numpy.concatenate([arr, pad], axis=0)
        new_data.append(jax.device_put(arr, sh))
    st = state.with_data(state.names, new_data)
    return st


def crop_level(arr, nbox: int):
    """Crop pad boxes after a sharded computation."""
    return arr[:nbox]
