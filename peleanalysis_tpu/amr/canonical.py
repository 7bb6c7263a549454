"""Position-independent (canonical-frame) cluster substates.

The sparse-refinement cluster path (amr/cluster.py) processes each finest-
level cluster as a dense patch.  A per-cluster engine that bakes ABSOLUTE
positions into its jaxpr — fill slice offsets, enum-engine gbox los —
compiles once per cluster even for equal-shaped clusters at different
positions.  The reference never pays this: its per-box kernels are
position-independent by construction (DistributionMapping + MFIter loops,
/root/reference/Src/grad.cpp:160-163).

This module restores that property for compiled engines: each cluster is
TRANSLATED
to a canonical frame —

  * the cluster's fine bbox is aligned DOWN to the total refinement ratio
    (so every coarse translation is integral and all c-f phases are
    preserved) and its extents padded UP to a bucket granule;
  * every coarser level enters as a translated WINDOW (the exact region the
    tool's fills read, sized by ``ngrow_max`` + interp stencil + an
    ``extra_margin`` for chained stencil stages) instead of the global
    coarse level;
  * the canonical geometry/lmeta/BoxArrays are identical for every cluster
    in the same bucket, so ``hier_fingerprint`` matches and ALL equal-bucket
    clusters share ONE compiled engine (amr/dense.shared_engine); the
    position enters only through traced data (window contents, masks,
    coordinate fields) and through host-side re-translation of outputs.

Exactness: window contents are crops of the global dense arrays; hole cells
are refilled from the window's own coarser level exactly as the global fill
would (values are pure functions of the same coarse data); cluster
separation (cluster_boxes ``dist``) keeps other clusters' fine data out of
reach.

Boundary-adjacent clusters (windows reaching past the physical domain in a
NON-periodic dim) are canonicalized too, by PINNING the canonical domain
edge: in each crossing dim the canonical geometry's domain carries the true
(translated) domain edge instead of the window edge, so the fill machinery
(_grow_level0's padded-bbox regrow, _apply_exterior_bc) applies the exact
BC at the exact position — structurally, per boundary SIGNATURE (which
sides cross + the frame's offset to the edge), while position along the
boundary face stays traced data.  Equal-signature clusters share one
compiled engine (the signature enters hier_fingerprint through the geoms).
Clusters whose WINDOWS reach past a PERIODIC edge (common whenever margins
are wide — e.g. curvature's chained stencils — and universal for
fully-periodic HIT-style cases) are canonicalized too, by WRAP-CROPPING:
the window crop indexes the global level arrays modulo the level's domain
extent, so window cells past the edge carry the exact values (and
in_level/covered masks) the global periodic fill would read from the
opposite side.  The canonical geometry stays non-periodic with the domain
spanning the window in that dim — identical to an interior cluster's, so
wrap clusters share the INTERIOR engine (no new signature).  This is exact
only when the wrap stays a pure ghost-data effect, gated per cluster:

  * the cluster's fine boxes keep >= 2 fine cells from the periodic face
    (so no emitted isosurface key or BC application reaches the fold the
    dense engine applies at the seam);
  * no fine-level in-level data lies within same-level ghost reach of the
    grown fine window THROUGH the wrap (dense would fill those ghosts from
    the periodic image; a window cannot);
  * every level's window extent fits within one period.

Clusters failing a gate fall back to the round-3 exact legacy path,
flagged infos[i].canonical False.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import numpy as np

from .box import Box, BoxArray
from .cluster import cluster_boxes
from .geometry import Geometry


@dataclasses.dataclass
class CanonInfo:
    canonical: bool                    # False -> legacy (boundary) substate
    shift: Optional[np.ndarray]        # fine-level cells: global = canon + shift
    windows: Optional[List[Box]]       # GLOBAL window box per level


def _ceil_to(v: int, g: int) -> int:
    return ((v + g - 1) // g) * g


def _floor_align(v: int, a: int) -> int:
    return (v // a) * a if v >= 0 else -((-v + a - 1) // a) * a


def _crop_np(arr: np.ndarray, src_box: Box, dst_box: Box,
             fill=False) -> np.ndarray:
    """Crop dst_box out of a host array covering src_box; out-of-range
    regions take ``fill``."""
    out_shape = arr.shape[:-3] + dst_box.shape
    out = np.full(out_shape, fill, dtype=arr.dtype)
    isect = src_box.intersect(dst_box)
    if isect.is_empty():
        return out
    ssl = tuple(slice(isect.lo[d] - src_box.lo[d],
                      isect.hi[d] - src_box.lo[d] + 1) for d in range(3))
    dsl = tuple(slice(isect.lo[d] - dst_box.lo[d],
                      isect.hi[d] - dst_box.lo[d] + 1) for d in range(3))
    pre = (slice(None),) * (arr.ndim - 3)
    out[pre + dsl] = arr[pre + ssl]
    return out


def _crop_dev_fn():
    import jax

    @partial(jax.jit, static_argnames=("size",))
    def crop(arr, starts, size):
        import jax.numpy as jnp
        s = [jnp.asarray(starts[d], jnp.int32) for d in range(3)]
        return jax.lax.dynamic_slice(
            arr, (jnp.zeros((), jnp.int32),) + tuple(s),
            (arr.shape[0],) + size)

    return crop


_CROP_DEV = None


def _crop_dev(arr, starts, size):
    """dynamic_slice with TRACED starts: one compile serves every cluster's
    window crop of the same (global, window) shape pair."""
    global _CROP_DEV
    if _CROP_DEV is None:
        _CROP_DEV = _crop_dev_fn()
    return _CROP_DEV(arr, np.asarray(starts, np.int32), tuple(size))


def _take3_fn():
    import jax

    @jax.jit
    def take3(arr, ix, iy, iz):
        return arr[:, ix[:, None, None], iy[None, :, None],
                   iz[None, None, :]]

    return take3


_TAKE3 = None


def _crop_dev_wrap(arr, src_box: Box, dst_box: Box, dom: Box, wrap_dims):
    """Window crop with TRACED per-dim index vectors: wrap dims index the
    global array modulo the level domain ``dom``, others take the plain
    range.  Out-of-array positions (holes reached through the wrap, or
    exterior cells of pinned dims whose values the BC regrow overwrites)
    clamp — never read before refill.  One compile per (global, window)
    shape pair, shared across clusters."""
    global _TAKE3
    if _TAKE3 is None:
        _TAKE3 = _take3_fn()
    idx = []
    for d in range(3):
        p = np.arange(dst_box.lo[d], dst_box.hi[d] + 1)
        if d in wrap_dims:
            p = (p - dom.lo[d]) % dom.shape[d] + dom.lo[d]
        i = np.clip(p - src_box.lo[d], 0, src_box.shape[d] - 1)
        idx.append(i.astype(np.int32))
    return _TAKE3(arr, *idx)


def _crop_np_wrap(arr: np.ndarray, src_box: Box, dst_box: Box, dom: Box,
                  wrap_dims, fill=False) -> np.ndarray:
    """Host-mask analog of _crop_dev_wrap: modular indexing along wrap
    dims, ``fill`` outside the source array (out-of-bbox positions hold no
    level data -> not in-level, not covered)."""
    idx, valid = [], []
    for d in range(3):
        p = np.arange(dst_box.lo[d], dst_box.hi[d] + 1)
        if d in wrap_dims:
            p = (p - dom.lo[d]) % dom.shape[d] + dom.lo[d]
        i = p - src_box.lo[d]
        valid.append((i >= 0) & (i < src_box.shape[d]))
        idx.append(np.clip(i, 0, src_box.shape[d] - 1))
    out = arr[..., idx[0][:, None, None], idx[1][None, :, None],
              idx[2][None, None, :]]
    mask = (valid[0][:, None, None] & valid[1][None, :, None]
            & valid[2][None, None, :])
    return np.where(mask, out, fill)


def canonical_cluster_substates(state, ngrow_max: int = 1,
                                interp_stencil: int = 1,
                                extra_margin: int = 0,
                                waste_factor: float = 4.0, dist: int = 2,
                                granule: int = 32):
    """(groups, subs, base, infos): canonical-frame DenseAmrStates for the
    finest level's clusters (see module docstring).  ``ngrow_max`` is the
    largest ghost width the tool fills at any level; ``extra_margin`` adds
    coarse-window validity layers for tools that CHAIN stencil stages
    (each derived-field fill consumes one layer of window validity).
    Ineligible clusters (windows crossing the domain boundary, or a
    single-level hierarchy) come back as legacy global-coarse substates
    with infos[i].canonical False — exactly round 3's behavior.

    The result is CACHED on ``state`` (LRU 4, keyed by every geometric
    parameter): a warm re-run (new iso value, next tool in a session)
    reuses the substates — their window crops, masks, pinned caps and
    per-instance engine caches — instead of re-densifying the coarse
    levels and re-uploading every window (each re-upload is a
    host-to-device copy)."""
    import jax.numpy as jnp

    ckey = (ngrow_max, interp_stencil, extra_margin, waste_factor, dist,
            granule)
    cache = getattr(state, "_canon_cache", None)
    if cache is None:
        cache = state._canon_cache = {}
    hit = cache.pop(ckey, None)
    if hit is not None:
        cache[ckey] = hit               # move-to-end (LRU)
        return hit

    from .cluster import cluster_substates
    from .dense import DenseAmrState, DenseLevelMeta, _assemble_dense
    from .hierarchy import AmrMeta

    meta = state.meta
    fin = meta.n_levels - 1
    groups = cluster_boxes(meta.bas[fin], waste_factor, dist)
    base = DenseAmrState.from_batched_coarse_only(state)
    boxes = list(meta.bas[fin])
    if fin == 0:
        legacy_g, legacy_s, legacy_b = cluster_substates(
            state, waste_factor, dist)
        return (legacy_g, legacy_s, legacy_b,
                [CanonInfo(False, None, None) for _ in legacy_g])

    # fine-cells-per-level-l-cell and alignment for integral translations
    F = [int(np.prod(meta.ref_ratio[l:fin])) for l in range(fin + 1)]
    R0 = F[0]
    gran = _ceil_to(max(granule, R0), R0)
    dom_f = meta.geoms[fin].domain

    # ---- bucketed, aligned, domain-fitted fine frames ----------------------
    frames = []                        # (shift (3,), ext_b (3,)) per group
    clu_lo, clu_hi = [], []            # cluster bbox per group (fine cells)
    for g in groups:
        lo = np.min([boxes[i].lo for i in g], axis=0)
        hi = np.max([boxes[i].hi for i in g], axis=0)
        clu_lo.append(lo)
        clu_hi.append(hi)
        shift, ext = [], []
        for d in range(3):
            if meta.ndim2 and d == 2:
                # DIM=2: the frame carries the EXACT fine z extent (no z
                # bucketing — a granule-deep window of z-uniform planes is
                # pure waste) and pins both z edges below
                shift.append(dom_f.lo[2])
                ext.append(dom_f.shape[2])
                continue
            lo_al = _floor_align(int(lo[d]), R0)
            eb = _ceil_to(int(hi[d]) - lo_al + 1, gran)
            # bucket padding may poke past the domain hi: slide the frame
            # down (keeping R0 alignment) when a fit exists
            over = lo_al + eb - 1 - dom_f.hi[d]
            if over > 0:
                slide = _ceil_to(over, R0)
                if lo_al - slide >= dom_f.lo[d]:
                    lo_al -= slide
            shift.append(lo_al)
            ext.append(eb)
        frames.append((np.asarray(shift), tuple(ext)))

    # ---- canonical windows per bucket (ext_b) ------------------------------
    def windows_canonical(ext_b):
        W = [None] * (fin + 1)
        W[fin] = Box((0, 0, 0), tuple(e - 1 for e in ext_b))
        for lev in range(fin, 0, -1):
            cb = (W[lev].grow(ngrow_max).coarsen(meta.ref_ratio[lev - 1])
                  .grow(interp_stencil + extra_margin))
            W[lev - 1] = cb
        return W

    win_cache = {}

    def windows_for(ext_b):
        if ext_b not in win_cache:
            win_cache[ext_b] = windows_canonical(ext_b)
        return win_cache[ext_b]

    def crossing(shift, W_c):
        """Per dim [lo, hi]: do the grown windows reach past the true
        domain edge on that side at any level?"""
        cross = [[False, False] for _ in range(3)]
        for lev in range(fin + 1):
            wg = W_c[lev].shift(tuple(int(shift[d]) // F[lev]
                                      for d in range(3))).grow(ngrow_max)
            dom = meta.geoms[lev].domain
            for d in range(3):
                if wg.lo[d] < dom.lo[d]:
                    cross[d][0] = True
                if wg.hi[d] > dom.hi[d]:
                    cross[d][1] = True
        return cross

    # ---- anchor boundary-crossing dims to the domain edge ------------------
    # A pinned domain edge enters the compile (BC position is structural),
    # so two clusters crossing the same side at DIFFERENT offsets would get
    # different signatures.  Anchoring the frame AT the edge in each
    # crossing dim makes the offset canonical (0), so all clusters sharing
    # a (crossing-pattern, bucket) pair share ONE engine — the common
    # production case is many clusters along the same domain face.  The
    # frame grows toward the near edge by < the window margin (crossing
    # implies the edge is within reach), bucket-padded.
    for gi in range(len(groups)):
        shift, ext_b = frames[gi]
        cross = crossing(shift, windows_for(ext_b))
        if not any(any(c) for c in cross):
            continue
        ns, ne = [int(s) for s in shift], list(ext_b)
        for d in range(3):
            if meta.ndim2 and d == 2:
                continue               # z already exact + edge-pinned
            lo_x, hi_x = cross[d]
            if not (lo_x or hi_x) or meta.geoms[0].is_periodic[d]:
                continue               # periodic crossing -> legacy later
            if lo_x:
                ns[d] = dom_f.lo[d]
                ne[d] = _ceil_to(int(clu_hi[gi][d]) - dom_f.lo[d] + 1,
                                 gran)
            else:                      # hi side only: anchor frame hi AT it
                e = _ceil_to(dom_f.hi[d] + 1
                             - _floor_align(int(clu_lo[gi][d]), R0),
                             gran)
                s = dom_f.hi[d] + 1 - e
                if s < dom_f.lo[d]:
                    s = dom_f.lo[d]       # tiny domain: lo-anchor instead
                ns[d], ne[d] = s, e
        frames[gi] = (np.asarray(ns), tuple(ne))

    def wrap_dims_for(gi, shift, W_c, cross):
        """Dims whose periodic window crossing is served by WRAP-CROPPING
        (module docstring gates), or None -> the cluster must go legacy
        (some periodic crossing is not a pure ghost-data effect)."""
        dims = []
        for d in range(3):
            per = meta.geoms[0].is_periodic[d]
            big = any(meta.geoms[lev].domain.shape[d] > 1
                      for lev in range(fin + 1))
            if not (per and big and (cross[d][0] or cross[d][1])):
                continue
            # fine boxes must keep clear of the periodic face: the dense
            # enum engine FOLDS node keys at the seam (marching_cubes
            # periodic-image folding); a >=2-cell gap keeps every emitted
            # key and ghost-ring dual node strictly interior
            if (int(clu_lo[gi][d]) - dom_f.lo[d] < 2
                    or dom_f.hi[d] - int(clu_hi[gi][d]) < 2):
                return None
            # each level's window must fit in one period (modular indexing
            # would alias itself otherwise)
            if any(W_c[lev].shape[d]
                   > meta.geoms[lev].domain.shape[d]
                   for lev in range(fin + 1)):
                return None
            # no same-level fine data within ghost reach through the wrap
            # (dense would fill those ghosts from the periodic image)
            G = (W_c[fin].shift(tuple(int(shift[k]) for k in range(3)))
                 .grow(ngrow_max))
            for off in (-dom_f.shape[d], dom_f.shape[d]):
                sh = [0, 0, 0]
                sh[d] = off
                Gs = G.shift(tuple(sh))
                if any(not Gs.intersect(b).is_empty() for b in boxes):
                    return None
            dims.append(d)
        return tuple(dims)

    def pinned_domain(shift, W_c, wrap_dims) -> Optional[Box]:
        """Level-0 canonical DOMAIN for this cluster, or None -> legacy.

        Interior cluster: domain == W_c[0] (all BC positions beyond every
        read).  A dim whose grown windows reach past the true domain edge
        on a non-periodic side gets that edge PINNED (true edge, translated
        to the canonical frame) so the engine's BC application lands
        exactly where the global fill's would; a reach past a PERIODIC
        edge is served by a wrap-cropped window (``wrap_dims``, gated by
        wrap_dims_for) with interior treatment, falling back to legacy
        when a gate fails (None here).  A periodic dim whose extent is 1
        at every level pins instead — wrap and foextrap coincide there,
        e.g. the z dim of a DIM=2 plotfile.  DIM=2 frames carry
        the exact fine z extent (set in the frames loop) with both z edges
        pinned, so 2-D scattered states share engines too."""
        cross = crossing(shift, W_c)
        dom0 = meta.geoms[0].domain
        W0 = W_c[0]
        lo_c, hi_c = [], []
        for d in range(3):
            if d in wrap_dims:
                # periodic crossing served by wrap-cropped window data:
                # interior treatment (no BC position enters the compile —
                # shares the interior engine)
                lo_c.append(W0.lo[d])
                hi_c.append(W0.hi[d])
                continue
            if ((cross[d][0] or cross[d][1])
                    and meta.geoms[0].is_periodic[d]
                    and any(meta.geoms[lev].domain.shape[d] > 1
                            for lev in range(fin + 1))):
                return None
            s0 = int(shift[d]) // F[0]
            # clamp to the window: when only a coarse level's GROW ring
            # crosses (no window does), the true edge sits outside W0 —
            # those grown positions are never read by fine outputs (reads
            # are cbox-slices inside the windows), so the window edge is
            # the exact round-3 semantics there
            lo_c.append(max(dom0.lo[d] - s0, W0.lo[d])
                        if cross[d][0] else W0.lo[d])
            hi_c.append(min(dom0.hi[d] - s0, W0.hi[d])
                        if cross[d][1] else W0.hi[d])
        return Box(tuple(lo_c), tuple(hi_c))

    # ---- legacy fallback builder (round-3 path) ----------------------------
    def legacy_sub(g):
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
            sub._covered[lev] = base.covered_mask(lev)
        return sub

    # ---- canonical geoms/lmeta shared per bucket+signature -----------------
    dx0 = meta.geoms[0].dx

    def canon_geoms(W_c, dom_c):
        # the index->x map must stay x(i) = (i - W0.lo + 0.5)*dx regardless
        # of where the domain box sits inside the window (pinned boundary
        # signatures shrink it), so every shift convention downstream holds:
        # prob_lo anchors the domain lo at its window-relative offset
        plo = tuple((dom_c.lo[d] - W_c[0].lo[d]) * dx0[d] for d in range(3))
        g0 = Geometry(dom_c, plo,
                      tuple(plo[d] + dom_c.shape[d] * dx0[d]
                            for d in range(3)),
                      (False, False, False))
        gs = [g0]
        for lev in range(1, fin + 1):
            g = gs[-1].refine(meta.ref_ratio[lev - 1])
            if meta.ndim2:
                # real DIM=2 hierarchies do NOT refine z (promote_2d gives
                # every level a z domain straight from the 2-D file) — a
                # blind refine would claim z in-domain positions the data
                # does not have, skipping the exterior z BC and leaving
                # coarse-upsample values in the z ghosts (measured: gz != 0
                # on a z-uniform field).  Take each level's TRUE z bounds
                # (z is never translated: shift[2] anchors at dom_f.lo[2]).
                tz = meta.geoms[lev].domain
                d = g.domain
                g = Geometry(Box((d.lo[0], d.lo[1], tz.lo[2]),
                                 (d.hi[0], d.hi[1], tz.hi[2])),
                             g.prob_lo, g.prob_hi, g.is_periodic,
                             g.coord_sys)
            gs.append(g)
        return gs

    # hoist per-level host mask sources once (np; avoids re-fetching)
    inlev_np = [base.in_level_mask_np(lev) for lev in range(fin)]
    cov_np = [np.asarray(base.covered_mask(lev)) for lev in range(fin)]

    # ---- plan every cluster's windows FIRST, then pad ONCE -----------------
    # the padded global shape is a compile key for both jnp.pad and the
    # window crop: growing it incrementally per cluster forced a fresh pad
    # + crop compile per cluster.  One union pad -> one pad op + one crop
    # compile per (global, window-shape) pair.
    plan = []                          # global windows or None per group
    doms = []                          # pinned canonical domain per group
    wraps = []                         # periodic wrap-crop dims per group
    for gi, g in enumerate(groups):
        shift, ext_b = frames[gi]
        if ext_b not in win_cache:
            win_cache[ext_b] = windows_canonical(ext_b)
        W_c = win_cache[ext_b]
        wd = wrap_dims_for(gi, shift, W_c, crossing(shift, W_c))
        dom_c = pinned_domain(shift, W_c, wd) if wd is not None else None
        doms.append(dom_c)
        wraps.append(wd or ())
        if dom_c is None:              # ungated periodic crossing -> legacy
            plan.append(None)
            continue
        plan.append([W_c[lev].shift(tuple(int(shift[d]) // F[lev]
                                          for d in range(3)))
                     for lev in range(fin + 1)])
    pad_data = list(base.data[:fin])
    pad_boxes = [base.lmeta[lev].bbox for lev in range(fin)]
    for lev in range(fin):
        # wrap dims fold back into the domain (modular crop) — they demand
        # no union growth along that axis
        need = []
        pb = pad_boxes[lev]
        for gi, wg in enumerate(plan):
            if wg is None:
                continue
            b = wg[lev]
            if wraps[gi]:
                b = Box(tuple(pb.lo[d] if d in wraps[gi] else b.lo[d]
                              for d in range(3)),
                        tuple(pb.hi[d] if d in wraps[gi] else b.hi[d]
                              for d in range(3)))
            need.append(b)
        if not need:
            continue
        lo_n = np.min([b.lo for b in need] + [pb.lo], axis=0)
        hi_n = np.max([b.hi for b in need] + [pb.hi], axis=0)
        lo_p = [int(pb.lo[d] - lo_n[d]) for d in range(3)]
        hi_p = [int(hi_n[d] - pb.hi[d]) for d in range(3)]
        if any(lo_p) or any(hi_p):
            pad_data[lev] = jnp.pad(
                pad_data[lev],
                [(0, 0)] + [(lo_p[d], hi_p[d]) for d in range(3)])
            pad_boxes[lev] = Box(tuple(lo_n), tuple(hi_n))

    subs, infos = [], []
    for gi, g in enumerate(groups):
        shift, ext_b = frames[gi]
        W_c = win_cache[ext_b]
        if plan[gi] is None:
            subs.append(legacy_sub(g))
            infos.append(CanonInfo(False, None, None))
            continue
        W_g = plan[gi]
        geoms_c = canon_geoms(W_c, doms[gi])
        # bas must be CANONICAL for fingerprint-equality (engine sharing);
        # the true translated fine layout enters only through the pre-set
        # in_level mask (traced data) and the assembly below
        bas_c = [BoxArray([W_c[lev]]) for lev in range(fin + 1)]
        ba_t = BoxArray([boxes[i].shift(tuple(-shift)) for i in g])
        meta_g = AmrMeta(geoms_c, bas_c, meta.ref_ratio, meta.time,
                         None, meta.ndim2)
        lmeta_g = [DenseLevelMeta(W_c[lev], geoms_c[lev], 1.0)
                   for lev in range(fin)]
        lmeta_g.append(DenseLevelMeta(
            W_c[fin], geoms_c[fin], ba_t.total_cells() / W_c[fin].size))
        # window data: traced dynamic_slice crops (one compile per shape);
        # wrap clusters use modular index-vector crops instead (same
        # one-compile-per-shape-pair sharing)
        data_g = []
        for lev in range(fin):
            if wraps[gi]:
                data_g.append(_crop_dev_wrap(
                    pad_data[lev], pad_boxes[lev], W_g[lev],
                    meta.geoms[lev].domain, wraps[gi]))
            else:
                starts = [W_g[lev].lo[d] - pad_boxes[lev].lo[d]
                          for d in range(3)]
                data_g.append(_crop_dev(pad_data[lev], starts,
                                        W_c[lev].shape))
        data_g.append(_assemble_dense(state.data[fin][np.asarray(g)],
                                      ba_t, W_c[fin]))
        sub = DenseAmrState(meta_g, state.names, data_g, lmeta_g)
        for lev in range(fin):
            bb = base.lmeta[lev].bbox
            if wraps[gi]:
                dm = meta.geoms[lev].domain
                sub._in_level[lev] = jnp.asarray(_crop_np_wrap(
                    inlev_np[lev], bb, W_g[lev], dm, wraps[gi]))
                sub._covered[lev] = jnp.asarray(_crop_np_wrap(
                    cov_np[lev], bb, W_g[lev], dm, wraps[gi]))
            else:
                sub._in_level[lev] = jnp.asarray(
                    _crop_np(inlev_np[lev], bb, W_g[lev]))
                sub._covered[lev] = jnp.asarray(
                    _crop_np(cov_np[lev], bb, W_g[lev]))
        # fine in_level = union of the TRANSLATED true boxes (canonical bas
        # would say all-true); covered(fin) has no finer level -> lazy zeros
        from .dense import _union_mask_np
        sub._in_level[fin] = jnp.asarray(_union_mask_np(ba_t, W_c[fin]))
        sub._canon_shift = shift
        sub._canon_windows = W_g
        sub._canon_wraps = wraps[gi]
        subs.append(sub)
        infos.append(CanonInfo(True, shift, W_g))
    cache[ckey] = (groups, subs, base, infos)
    while len(cache) > 4:
        cache.pop(next(iter(cache)))
    return groups, subs, base, infos


def global_frame(out_state, info: CanonInfo):
    """Relabel a canonical-frame RESULT state with its GLOBAL window lmeta,
    so host-side merges can slice it by global box coordinates (the data
    arrays are shared, only the bbox labels change)."""
    if not info.canonical:
        return out_state
    from .dense import DenseAmrState, DenseLevelMeta

    lmeta = [DenseLevelMeta(info.windows[lev], lm.geom, lm.fill_frac)
             for lev, lm in enumerate(out_state.lmeta)]
    st = DenseAmrState(out_state.meta, out_state.names, out_state.data,
                       lmeta)
    st._in_level = out_state._in_level
    st._covered = out_state._covered
    return st


def coarse_only_state(state, base=None):
    """Global dense hierarchy of levels 0..fin-1 (for the coarse pass that
    complements canonical fine-cluster runs), with the level-(fin-1) covered
    mask taken from the FULL hierarchy so fine-covered cells are excluded
    exactly as in a global run."""
    from .dense import DenseAmrState
    from .hierarchy import AmrMeta

    meta = state.meta
    fin = meta.n_levels - 1
    if base is None:
        base = DenseAmrState.from_batched_coarse_only(state)
    meta_c = AmrMeta(meta.geoms[:fin], meta.bas[:fin],
                     meta.ref_ratio[:fin - 1], meta.time,
                     meta.level_steps[:fin] if meta.level_steps else None,
                     meta.ndim2)
    ds = DenseAmrState(meta_c, state.names, list(base.data[:fin]),
                       list(base.lmeta[:fin]))
    for lev in range(fin):
        ds._in_level[lev] = base.in_level_mask(lev)
        ds._covered[lev] = base.covered_mask(lev)
    return ds
