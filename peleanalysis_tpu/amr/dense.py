"""Dense canonical level representation — the device fast path.

The batched-box model (hierarchy.py) mirrors the reference's MultiFab layout,
but its ghost fill is a random gather.  The dense layout for block-structured
AMR is one array per level covering the union bounding box of that level's
boxes:

    data: [ncomp, BX+2G, BY+2G, BZ+2G]   (G = ghost width)
    covered_by_level (bool [BX, BY, BZ]): cell lies inside some box

Assembly from boxes is a static loop of contiguous dynamic_update_slices;
ghost fill becomes slice copies (periodic / physical BC) plus a factor-r
upsample of the coarser level's dense array (piecewise-constant `repeat` or
trilinear fixed-weight interpolation — both compile to fast fused XLA);
stencils are pure slicing arithmetic fused into single HBM passes.  "Hole"
cells inside the bbox but outside the level's boxes simply take the coarse
upsampled values, exactly like ghost cells (FillPatchTwoLevels semantics,
/root/reference/Src/isosurface.cpp:1509-1527).

Trade-off vs the reference design: we compute on bbox_volume instead of
union_volume.  For Pele-style refinement the union is localized and blocky,
so the waste is small; when it isn't, tools fall back to the batched/gather
path (ops/fill.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from .box import Box, BoxArray
from .geometry import Geometry
from .hierarchy import AmrMeta, AmrState


@dataclasses.dataclass
class DenseLevelMeta:
    bbox: Box                 # union bounding box (index space, no ghosts)
    geom: Geometry
    fill_frac: float          # union_volume / bbox_volume


class DenseAmrState:
    """Per-level dense arrays [ncomp, *bbox_shape] (no ghosts stored;
    fills return grown arrays)."""

    def __init__(self, meta: AmrMeta, names: Sequence[str],
                 data: List[jnp.ndarray], lmeta: List[DenseLevelMeta]):
        self.meta = meta
        self.names = list(names)
        self.data = data
        self.lmeta = lmeta
        self._covered: List[Optional[jnp.ndarray]] = [None] * meta.n_levels
        self._in_level: List[Optional[jnp.ndarray]] = [None] * meta.n_levels
        self._in_level_np: List[Optional[np.ndarray]] = [None] * meta.n_levels

    @classmethod
    def from_batched(cls, state: AmrState) -> "DenseAmrState":
        meta = state.meta
        data = []
        lmeta = []
        for lev in range(meta.n_levels):
            ba = meta.bas[lev]
            bbox = ba.minimal_box()
            lmeta.append(DenseLevelMeta(
                bbox, meta.geoms[lev],
                ba.total_cells() / bbox.size))
            data.append(_assemble_dense(state.data[lev], ba, bbox))
        return cls(meta, state.names, data, lmeta)

    @classmethod
    def from_batched_coarse_only(cls, state: AmrState) -> "DenseAmrState":
        """Dense arrays for all levels EXCEPT the finest (data[finest] is
        None; metadata present).  Used by the sparse-refinement cluster path
        (geom/marching_cubes.extract_isosurface_sparse), where the finest
        level's union bbox would not fit and is assembled per cluster."""
        meta = state.meta
        data, lmeta = [], []
        for lev in range(meta.n_levels):
            ba = meta.bas[lev]
            bbox = ba.minimal_box()
            lmeta.append(DenseLevelMeta(
                bbox, meta.geoms[lev], ba.total_cells() / bbox.size))
            data.append(_assemble_dense(state.data[lev], ba, bbox)
                        if lev < meta.n_levels - 1 else None)
        return cls(meta, state.names, data, lmeta)

    @classmethod
    def meta_only(cls, state: AmrState) -> "DenseAmrState":
        """Metadata-only view (data[lev] is None for every level): valid for
        the mask accessors (covered_mask/in_level_mask), which are computed
        purely from BoxArray metadata — no dense assembly."""
        meta = state.meta
        lmeta = []
        for lev in range(meta.n_levels):
            ba = meta.bas[lev]
            bbox = ba.minimal_box()
            lmeta.append(DenseLevelMeta(
                bbox, meta.geoms[lev], ba.total_cells() / bbox.size))
        return cls(meta, state.names, [None] * meta.n_levels, lmeta)

    @classmethod
    def from_plotfile(cls, path: str, names=None, max_level=None,
                      is_periodic=None, dtype=None) -> "DenseAmrState":
        return cls.from_batched(AmrState.from_plotfile(
            path, names, max_level, is_periodic, dtype))

    # -- masks ---------------------------------------------------------------
    def in_level_mask(self, lev: int) -> jnp.ndarray:
        """bool [*bbox_shape]: cell covered by this level's boxes."""
        if self._in_level[lev] is None:
            self._in_level[lev] = jnp.asarray(self.in_level_mask_np(lev))
        return self._in_level[lev]

    def in_level_mask_np(self, lev: int) -> np.ndarray:
        """Host-side in-level mask: never touches the device (np.asarray of
        the device mask is a device-to-host copy per call)."""
        if self._in_level_np[lev] is None:
            if self._in_level[lev] is not None:
                # a padded/sharded state may carry a replaced device mask
                # (parallel/dense_shard.pad_state_to): that one is the truth
                self._in_level_np[lev] = np.asarray(self._in_level[lev])
            else:
                self._in_level_np[lev] = _union_mask_np(
                    self.meta.bas[lev], self.lmeta[lev].bbox)
        return self._in_level_np[lev]

    def covered_mask(self, lev: int) -> jnp.ndarray:
        """bool: cell covered by the NEXT finer level (+periodic images)."""
        if self._covered[lev] is None:
            meta = self.meta
            bbox = self.lmeta[lev].bbox
            out = np.zeros(bbox.shape, dtype=bool)
            if lev + 1 < meta.n_levels:
                r = meta.ref_ratio[lev]
                fine_c = meta.bas[lev + 1].coarsen(r)
                per = meta.geoms[lev].is_periodic
                dom = meta.geoms[lev].domain
                from .hierarchy import _periodic_shifts
                for fb in fine_c:
                    for sh in _periodic_shifts(per, dom):
                        isect = bbox.intersect(fb.shift(sh))
                        if not isect.is_empty():
                            sl = tuple(slice(isect.lo[d] - bbox.lo[d],
                                             isect.hi[d] - bbox.lo[d] + 1)
                                       for d in range(3))
                            out[sl] = True
            self._covered[lev] = jnp.asarray(out)
        return self._covered[lev]

    def valid_mask(self, lev: int) -> jnp.ndarray:
        return self.in_level_mask(lev) & ~self.covered_mask(lev)

    def comp(self, name: str) -> int:
        return self.names.index(name)

    def with_data(self, names: Sequence[str],
                  data: List[jnp.ndarray]) -> "DenseAmrState":
        st = DenseAmrState(self.meta, names, data, self.lmeta)
        st._covered = self._covered
        st._in_level = self._in_level
        st._in_level_np = self._in_level_np
        return st

    # -- back to boxes / plotfile ---------------------------------------------
    def to_batched(self) -> AmrState:
        meta = self.meta
        data = []
        for lev in range(meta.n_levels):
            data.append(_scatter_boxes(self.data[lev], meta.bas[lev],
                                       self.lmeta[lev].bbox,
                                       meta.pad_shape(lev)))
        return AmrState(meta, self.names, data)

    def to_plotfile(self, path: str, names=None) -> None:
        if jax.default_backend() == "cpu" and not _DISPATCH_COSTLY:
            self.to_batched().to_plotfile(path, names)
            return
        self._packed_dev()[1](path, names)

    def to_plotfile_async(self, path: str, submit, names=None) -> None:
        """Write-back plotfile write (Session.async_writes): dispatch the
        packed layout, initiate the device->host transfer, and queue the
        host-side slicing + FAB write on the session's write-back thread so
        the CALLER's next device work overlaps this output's fetch."""
        flat_dev, decode = self._packed_dev()
        try:
            flat_dev.copy_to_host_async()
        except Exception:
            pass
        submit(lambda: decode(path, names, flat_dev))

    def _packed_dev(self):
        # direct dense writer: slice every box window out of the union
        # arrays and fetch ALL levels in one flat transfer — skips the
        # to_batched() scatter (an eager per-box op storm) and per-level
        # fetches (see hierarchy.to_plotfile)
        from .hierarchy import write_level_fabs
        key = ("dense_pack",) + hier_fingerprint(self) \
            + (tuple(d.shape for d in self.data),
               str(self.data[0].dtype))
        fn = _LAYOUT_FNS.get(key)
        if fn is None:
            bas = self.meta.bas
            los = [lm.bbox.lo for lm in self.lmeta]

            def pack(levels):
                parts = []
                for d, ba, lo in zip(levels, bas, los):
                    for b in ba:
                        parts.append(d[(slice(None),)
                                       + tuple(slice(b.lo[k] - lo[k],
                                                     b.hi[k] - lo[k] + 1)
                                               for k in range(3))].ravel())
                return jnp.concatenate(parts)
            fn = _cache_layout_fn(key, jax.jit(pack))
        flat_dev = fn(list(self.data))
        meta, self_names = self.meta, self.names
        data_shapes = [d.shape[0] for d in self.data]

        def decode(path, names, dev=flat_dev):
            from .hierarchy import unflatten_level_fabs
            level_fabs = unflatten_level_fabs(np.asarray(dev),
                                              data_shapes, meta.bas)
            write_level_fabs(meta, names or self_names, level_fabs, path)
        return flat_dev, decode


# Eager per-box dynamic_slice/update loops pay one dispatch per op.  Off
# the CPU we jit the whole loop (one dispatch), cached by the structural
# key; on the CPU the eager loop is fine.  PELE_PACK_JIT=1 forces the
# jitted path (tests).
_DISPATCH_COSTLY = bool(int(
    __import__("os").environ.get("PELE_PACK_JIT", "0")))
_LAYOUT_FNS: dict = {}


def _cache_layout_fn(key, fn):
    _LAYOUT_FNS[key] = fn
    if len(_LAYOUT_FNS) > 128:
        _LAYOUT_FNS.pop(next(iter(_LAYOUT_FNS)))
    return fn


def _assemble_dense(batched: jnp.ndarray, ba: BoxArray, bbox: Box) -> jnp.ndarray:
    """[nbox, ncomp, *pad] -> [ncomp, *bbox_shape] via static dus loop."""
    def impl(bt):
        ncomp = bt.shape[1]
        out = jnp.zeros((ncomp,) + bbox.shape, dtype=bt.dtype)
        for i, b in enumerate(ba):
            blk = bt[i][(slice(None),) + tuple(slice(0, s) for s in b.shape)]
            out = jax.lax.dynamic_update_slice(
                out, blk, (0,) + tuple(b.lo[d] - bbox.lo[d]
                                       for d in range(3)))
        return out

    if jax.default_backend() == "cpu" and not _DISPATCH_COSTLY:
        return impl(batched)
    key = ("assemble", tuple((tuple(b.lo), tuple(b.shape)) for b in ba),
           tuple(bbox.lo), bbox.shape, tuple(batched.shape),
           str(batched.dtype))
    fn = _LAYOUT_FNS.get(key)
    if fn is None:
        fn = _cache_layout_fn(key, jax.jit(impl))
    return fn(batched)


def _scatter_boxes(dense: jnp.ndarray, ba: BoxArray, bbox: Box,
                   pad_shape: Tuple[int, ...]) -> jnp.ndarray:
    """[ncomp, *bbox_shape] -> [nbox, ncomp, *pad_shape]."""
    def impl(dn):
        ncomp = dn.shape[0]
        outs = []
        for b in ba:
            blk = jax.lax.dynamic_slice(
                dn, (0,) + tuple(b.lo[d] - bbox.lo[d] for d in range(3)),
                (ncomp,) + b.shape)
            pad = [(0, 0)] + [(0, pad_shape[d] - b.shape[d])
                              for d in range(3)]
            outs.append(jnp.pad(blk, pad))
        return jnp.stack(outs)

    if jax.default_backend() == "cpu" and not _DISPATCH_COSTLY:
        return impl(dense)
    key = ("scatter", tuple((tuple(b.lo), tuple(b.shape)) for b in ba),
           tuple(bbox.lo), bbox.shape, tuple(pad_shape),
           tuple(dense.shape), str(dense.dtype))
    fn = _LAYOUT_FNS.get(key)
    if fn is None:
        fn = _cache_layout_fn(key, jax.jit(impl))
    return fn(dense)


def _union_mask_np(ba: BoxArray, bbox: Box) -> np.ndarray:
    m = np.zeros(bbox.shape, dtype=bool)
    for b in ba:
        sl = tuple(slice(b.lo[d] - bbox.lo[d], b.hi[d] - bbox.lo[d] + 1)
                   for d in range(3))
        m[sl] = True
    return m


def hier_fingerprint(dstate) -> tuple:
    """Structural identity of a dense hierarchy: two states with equal
    fingerprints can share compiled engines (shapes, geoms, BoxArrays —
    everything the engine closures bake in; the data enters as args)."""
    meta = dstate.meta
    return (meta.n_levels, tuple(meta.ref_ratio),
            tuple((tuple(lm.bbox.lo), tuple(lm.bbox.hi))
                  for lm in dstate.lmeta),
            tuple((tuple(g.domain.lo), tuple(g.domain.hi),
                   tuple(g.prob_lo), tuple(g.prob_hi),
                   tuple(bool(p) for p in g.is_periodic))
                  for g in meta.geoms),
            tuple(tuple((tuple(b.lo), tuple(b.hi)) for b in ba)
                  for ba in meta.bas))


_ENGINE_LOCK = __import__("threading").Lock()


def shared_engine(registry: dict, cap: int, dstate, key, build):
    """LRU-capped cross-instance engine cache: re-TRACING a big jitted
    engine costs seconds warm, and repeated CLI runs over a time series
    build a fresh state per plotfile.  Thread-safe: the sparse path builds
    per-cluster engines from a thread pool, so their compiles overlap."""
    gkey = (hier_fingerprint(dstate), key)
    with _ENGINE_LOCK:
        fn = registry.pop(gkey, None)
        if fn is not None:
            registry[gkey] = fn              # move-to-end (LRU)
    if fn is None:
        fn = build()
        with _ENGINE_LOCK:
            fn = registry.setdefault(gkey, fn)
            while len(registry) > cap:
                registry.pop(next(iter(registry)))
    return fn
