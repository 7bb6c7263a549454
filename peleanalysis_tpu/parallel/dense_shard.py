"""SPMD domain decomposition for the dense canonical model.

The reference distributes boxes over MPI ranks
(DistributionMapping, /root/reference/Src/grad.cpp:160-163); the dense
model's multi-chip layout is a spatial shard: every level array
[ncomp, X, Y, Z] is sharded over a 1-D/2-D/3-D ``jax.sharding`` mesh whose
axes map onto the spatial dims ("x", "y", "z").  Fills and stencils are
slice/concat/pad arithmetic, so GSPMD lowers the shard-boundary reads to
halo collective-permutes between devices — the FillBoundary/MPI analog with
no hand-written communication (tests/test_halo.py proves the sharded
pipeline equal to unsharded; parallel/halo.py is the explicit
shard_map+ppermute alternative).  Pass shape=(2, 2) etc. for a 2-D/3-D
decomposition instead of X-slabs only; the devices form a plain list, so
the mesh shape follows the algorithm alone.

Levels whose extents do not divide the mesh are PADDED, not replicated:

  * lev > 0: the bounding box grows on the hi side of each sharded dim and
    the pad cells are ordinary "hole" cells (in_level False), which ghost
    fills overwrite with coarse upsampled values — semantically exact.
  * lev == 0 (spans the domain, no coarser level): pad cells are edge-copy
    placeholders masked out (in_level False); every ghost fill re-grows
    level 0 from the TRUE domain edge (ops/dense_fill._grow_level0), so pad
    positions carry exact BC values — foextrap/reflect copies, or wrap for
    periodic dims (wrap values are computed at fill time from the real
    edge, so they move with the data under any sharding).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

X_AXIS = "x"
SPATIAL_AXES = ("x", "y", "z")


def make_spatial_mesh(n_devices: Optional[int] = None,
                      shape: Optional[Sequence[int]] = None) -> Mesh:
    """1-D X-slab mesh by default; pass shape=(a, b[, c]) for a 2-D/3-D
    decomposition over ("x", "y"[, "z"])."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
    return Mesh(np.array(devs).reshape(shape), SPATIAL_AXES[: len(shape)])


def mesh_from_pp(pp, ndev: int) -> Mesh:
    """Mesh from the shared CLI keys: ndevices=N [mesh_shape=a b [c]]."""
    return make_spatial_mesh(ndev, pp.query_int_list("mesh_shape", None))


def _dim_axes(mesh: Mesh) -> List[Optional[str]]:
    """Mesh axis name (or None) per spatial dim 0..2."""
    names: List[Optional[str]] = [None, None, None]
    for ax in mesh.axis_names:
        names[SPATIAL_AXES.index(ax)] = ax
    return names


def _dim_sizes(mesh: Mesh) -> Tuple[int, int, int]:
    sizes = [1, 1, 1]
    for ax, n in zip(mesh.axis_names, mesh.devices.shape):
        sizes[SPATIAL_AXES.index(ax)] = int(n)
    return tuple(sizes)


def dense_sharding(mesh: Mesh) -> NamedSharding:
    """[ncomp, X, Y, Z] sharded over the mesh's spatial axes."""
    return NamedSharding(mesh, P(None, *_dim_axes(mesh)))


def mask_sharding(mesh: Mesh) -> NamedSharding:
    """[X, Y, Z] bool masks sharded over the mesh's spatial axes."""
    return NamedSharding(mesh, P(*_dim_axes(mesh)))


def pad_state_divisible(dstate, mesh: Mesh):
    """Grow each level's bounding box on the hi side of every sharded dim
    until its extent divides that mesh axis.  lev>0 pads are holes; lev-0
    pads are edge copies (see module docstring).  Returns a new
    DenseAmrState (masks rebuilt lazily), or dstate unchanged."""
    return pad_state_to(dstate, _dim_sizes(mesh))


def pad_state_to(dstate, sizes: Sequence[int]):
    """Pad every level's extents up to multiples of ``sizes`` (per dim).

    Two users: mesh sharding (extents must divide the mesh), and SHAPE
    BUCKETING (`shape_bucket=N` on the tools): rounding all extents to a
    granule means one compiled engine serves every hierarchy in the bucket
    — a time series whose refinement drifts between steps stops paying a
    cold compile per plotfile.  Pad cells are holes
    (lev>0) / edge copies (lev 0) exactly as for sharding, so results are
    unchanged (outputs never read pads)."""
    import jax.numpy as jnp

    from ..amr.box import Box
    from ..amr.dense import DenseAmrState, DenseLevelMeta

    sizes = tuple(int(max(s, 1)) for s in sizes)
    meta = dstate.meta
    new_data, new_lmeta, changed = [], [], False
    for lev in range(meta.n_levels):
        arr = dstate.data[lev]
        bbox = dstate.lmeta[lev].bbox
        pads = [(-arr.shape[1 + d]) % sizes[d] for d in range(3)]
        if not any(pads):
            new_data.append(arr)
            new_lmeta.append(dstate.lmeta[lev])
            continue
        changed = True
        new_bbox = Box(bbox.lo,
                       tuple(bbox.hi[d] + pads[d] for d in range(3)))
        new_lmeta.append(DenseLevelMeta(
            new_bbox, meta.geoms[lev],
            meta.bas[lev].total_cells() / new_bbox.size))
        widths = ((0, 0),) + tuple((0, p) for p in pads)
        mode = "edge" if lev == 0 else "constant"
        new_data.append(jnp.pad(arr, widths, mode=mode))
    if not changed:
        return dstate
    return DenseAmrState(meta, dstate.names, new_data, new_lmeta)


def shard_dense_state(dstate, mesh: Mesh):
    """Place every level's dense array (and masks) sharded over the mesh's
    spatial axes, padding non-divisible levels first."""
    # pad_state_divisible guarantees every level divides the mesh axes, so
    # the spatial sharding always applies (a replicated fallback here was
    # dead code, r5 review)
    dstate = pad_state_divisible(dstate, mesh)
    sh = dense_sharding(mesh)
    msh = mask_sharding(mesh)
    new_data = [jax.device_put(arr, sh) for arr in dstate.data]
    out = dstate.with_data(dstate.names, new_data)
    for lev in range(dstate.meta.n_levels):
        out._in_level[lev] = jax.device_put(dstate.in_level_mask(lev), msh)
    return out
