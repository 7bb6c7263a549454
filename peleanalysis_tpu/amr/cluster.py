"""Box clustering for sparse-refinement memory scaling.

The dense canonical model (amr/dense.py) materializes each level's union
BOUNDING BOX.  On a production plotfile whose finest level covers a few
percent of the domain in scattered regions, that is orders of magnitude more
device memory than the valid cells.  Tools that support it
split such a level into CLUSTERS — connected components of the BoxArray
(boxes within an interaction distance of 2 cells, the ghost-fill + dual-cell
influence radius) greedily merged while the cluster bounding box stays
reasonably full — and process one dense patch per cluster.

The reference has no analog (each MPI rank holds only its own boxes —
memory scales with valid cells by construction); this restores that scaling
property for the dense device layout.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .box import Box, BoxArray


def _adjacent(a: Box, b: Box, dist: int) -> bool:
    return not a.grow(dist).intersect(b).is_empty()


def connected_components(ba: BoxArray, dist: int = 2) -> List[List[int]]:
    """Union-find over boxes closer than `dist` cells (any overlap of
    grow(a, dist) with b).  dist=2 covers the 1-ghost fill plus the 1-cell
    dual-grid reach, so separate components never see each other's data."""
    n = len(ba)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    boxes = list(ba)
    for i in range(n):
        gi = boxes[i].grow(dist)
        for j in range(i + 1, n):
            if not gi.intersect(boxes[j]).is_empty():
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    comps = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    return list(comps.values())


def cluster_boxes(ba: BoxArray, waste_factor: float = 4.0,
                  dist: int = 2) -> List[List[int]]:
    """Connected components, then greedy merging of components while the
    merged bounding box wastes less than `waste_factor` x the contained
    cells.  Returns lists of box indices (each a dense patch)."""
    comps = connected_components(ba, dist)
    boxes = list(ba)

    def bbox_of(idxs):
        lo = np.min([boxes[i].lo for i in idxs], axis=0)
        hi = np.max([boxes[i].hi for i in idxs], axis=0)
        return Box(tuple(lo), tuple(hi))

    def cells_of(idxs):
        return sum(boxes[i].size for i in idxs)

    # sort components by bbox lo corner for deterministic greedy merging
    comps.sort(key=lambda c: bbox_of(c).lo)
    merged: List[List[int]] = []
    for comp in comps:
        if merged:
            cand = merged[-1] + comp
            bb = bbox_of(cand)
            if bb.size <= waste_factor * cells_of(cand):
                merged[-1] = cand
                continue
        merged.append(list(comp))
    return merged


def sparse_stats_parts(state, waste_factor: float = 4.0):
    """Decompose a sparse-refinement hierarchy for statistics tools
    (conditionalMean / jpdf / integral-style accumulations): returns
    (coarse_dstate, cluster_dstates, fine_ratio) where

      coarse_dstate   levels 0..fin-1 densified, with the GLOBAL
                      fine-covered mask on its finest level (so covered
                      coarse cells are excluded exactly as in the full run)
      cluster_dstates single-level dense states, one per finest-level
                      cluster (footprint ~ cluster bbox)
      fine_ratio      ref ratio fin-1 -> fin (weight rescale for tools
                      whose per-cell weights count finest-equivalent cells)

    Accumulating a masked/weighted statistic over coarse_dstate +
    every cluster_dstate visits exactly the valid cells of the full
    hierarchy, once each."""
    from .dense import DenseAmrState
    from .hierarchy import AmrMeta, AmrState

    meta = state.meta
    fin = meta.n_levels - 1
    meta_c = AmrMeta(meta.geoms[:fin], meta.bas[:fin],
                     meta.ref_ratio[:fin - 1], meta.time,
                     meta.level_steps[:fin] if meta.level_steps else None,
                     meta.ndim2)
    st_c = AmrState(meta_c, state.names, list(state.data[:fin]))
    ds_c = DenseAmrState.from_batched(st_c)
    # global covered mask on the new finest (computed from the FULL meta);
    # metadata-only — assembling the coarse levels a second time just for
    # this mask doubled the staging cost of every sparse stats run
    ds_c._covered[fin - 1] = DenseAmrState.meta_only(state).covered_mask(
        fin - 1)

    groups = cluster_boxes(meta.bas[fin], waste_factor)
    boxes = list(meta.bas[fin])
    clusters = []
    for g in groups:
        ba_g = BoxArray([boxes[i] for i in g])
        meta_g = AmrMeta([meta.geoms[fin]], [ba_g], [], meta.time,
                         None, meta.ndim2)
        st_g = AmrState(meta_g, state.names, [state.data[fin][np.asarray(g)]])
        clusters.append(DenseAmrState.from_batched(st_g))
    if len(clusters) > 1:
        # bucket-pad every cluster to the elementwise max shape (rounded to
        # a granule): the stats accumulation jits key on array SHAPES, so
        # equal-shape parts share one compiled contraction instead of one
        # per cluster (pads carry in_level=False and never accumulate)
        shapes = np.array([c.lmeta[0].bbox.shape for c in clusters])
        tgt = tuple(int(-(-v // 8) * 8) for v in shapes.max(axis=0))
        clusters = [_pad_single_level(c, tgt) for c in clusters]
    return ds_c, clusters, meta.ref_ratio[fin - 1]


def _pad_single_level(ds, tgt_shape):
    """Hi-side pad of a single-level dense part to ``tgt_shape``; the pad
    cells are hole cells (in_level False) that no masked statistic visits."""
    import jax.numpy as jnp

    from .box import Box
    from .dense import DenseAmrState, DenseLevelMeta, _union_mask_np

    bbox = ds.lmeta[0].bbox
    pads = [int(t - s) for t, s in zip(tgt_shape, bbox.shape)]
    if not any(pads):
        return ds
    nb = Box(bbox.lo, tuple(bbox.lo[d] + tgt_shape[d] - 1 for d in range(3)))
    data = [jnp.pad(ds.data[0], [(0, 0)] + [(0, p) for p in pads])]
    lmeta = [DenseLevelMeta(nb, ds.lmeta[0].geom,
                            ds.meta.bas[0].total_cells() / nb.size)]
    st = DenseAmrState(ds.meta, ds.names, data, lmeta)
    st._in_level[0] = jnp.asarray(_union_mask_np(ds.meta.bas[0], nb))
    return st


def needs_clustering(ba: BoxArray, waste_factor: float = 4.0,
                     min_cells: int = 1 << 21) -> bool:
    """True when the union bbox wastes more than waste_factor x the valid
    cells AND the bbox is big enough for the waste to matter."""
    bbox = ba.minimal_box()
    return (bbox.size > waste_factor * ba.total_cells()
            and bbox.size > min_cells)


def cluster_substates(state, waste_factor: float = 4.0, dist: int = 2):
    """Generic per-cluster DenseAmrStates for STENCIL tools (curvature
    without the composite smoothing solve; any chain of 1-ghost fills):
    coarse dense arrays shared zero-copy, the finest level assembled per
    cluster, coarse in-level/covered masks the GLOBAL ones.  Cluster
    separation (`dist`, connected_components) guarantees one cluster's
    1-ghost fills never reach another cluster's fine data, so per-cluster
    outputs equal the global dense run on every cluster cell.
    Returns (groups, substates, base) — groups[i] lists the finest-level
    box indices of substates[i]."""
    from .dense import DenseAmrState, DenseLevelMeta, _assemble_dense
    from .hierarchy import AmrMeta

    meta = state.meta
    fin = meta.n_levels - 1
    groups = cluster_boxes(meta.bas[fin], waste_factor, dist)
    base = DenseAmrState.from_batched_coarse_only(state)
    boxes = list(meta.bas[fin])
    subs = []
    for g in groups:
        ba_g = BoxArray([boxes[i] for i in g])
        meta_g = AmrMeta(meta.geoms, meta.bas[:fin] + [ba_g],
                         meta.ref_ratio, meta.time, meta.level_steps,
                         meta.ndim2)
        bbox_g = ba_g.minimal_box()
        lmeta_g = base.lmeta[:fin] + [DenseLevelMeta(
            bbox_g, meta.geoms[fin], ba_g.total_cells() / bbox_g.size)]
        data_g = list(base.data[:fin]) + [_assemble_dense(
            state.data[fin][np.asarray(g)], ba_g, bbox_g)]
        sub = DenseAmrState(meta_g, state.names, data_g, lmeta_g)
        for lev in range(fin):
            sub._in_level[lev] = base.in_level_mask(lev)
            # GLOBAL covered masks (the sub meta's fine BoxArray is only
            # this cluster — computing them lazily would mark coarse cells
            # under OTHER clusters as uncovered)
            sub._covered[lev] = base.covered_mask(lev)
        subs.append(sub)
    return groups, subs, base
