"""Marching-cubes isosurface extraction on the dual grid of the AMR
hierarchy — the engine behind the ``isosurface`` tool.

JAX re-design of PeleAnalysis Src/isosurface.cpp:1278-2269:

  * The dual grid's node coordinates are *data*: cell-center coordinate
    fields filled with the same piecewise-constant FillPatch as the state, so
    ghost/hole nodes collapse onto their coarse parents' centers and the
    coarse-fine seam is watertight by construction (isosurface.cpp:1450-1479,
    "degenerate water-tight hexes").
  * Per level, dual cells are processed where (a) every corner is uncovered
    by finer levels (the mask<0 bail, isosurface.cpp:435-437,1535-1563),
    (b) at least one corner belongs to the level (the union of per-box
    grow(validbox,1) loops, isosurface.cpp:1566-1570), (c) corners stay
    inside the (periodically grown) domain.
  * Node identity is an integer edge key — the sorted pair of packed
    (level, global-cell) ids of the edge's two corners, with collapsed ghost
    corners keyed by their coarse parent (the level-extended key SURVEY.md §7
    describes).  Dedup within and ACROSS levels is then an exact integer
    sort-unique — no epsilon-ball positional compare (improves on the
    reference's Node::operator<, isosurface.cpp:834-873).
  * Phase 1 (cube classification over the full dense level) runs jitted on
    device; phase 2 (vertex interpolation + table lookup) runs vectorized on
    the tiny active subset.

Orientation follows the standard table order; the reference's
CheckSurfaceNormal diagnostic is covered by the watertightness tests.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..amr.box import Box, BoxArray
from ..amr.dense import DenseAmrState
from ..io.mef import MEF
from ..ops.dense_fill import fill_dense_arrays, fill_dense_multilevel
from ..ops.fill import default_bc
from .mc_tables import (CORNER_OFFSETS, CORNER_PAIRS, EDGE_TABLE, TRI_COUNT,
                        TRI_TABLE)

_LEV_SHIFT = 54
_C_BITS = 18
_C_MASK = (1 << _C_BITS) - 1


def _pack_key(lev: np.ndarray, gx, gy, gz) -> np.ndarray:
    return ((lev.astype(np.int64) + 1) << _LEV_SHIFT
            | (gx.astype(np.int64) << (2 * _C_BITS))
            | (gy.astype(np.int64) << _C_BITS)
            | gz.astype(np.int64))


def _data_levels_cached(dstate: DenseAmrState, comps):
    """[coords | selected comps] per level, concatenated on device ONCE per
    (state, comps) instead of eager concats on every extraction."""
    cache = getattr(dstate, "_mc_datalevels", None)
    if cache is None:
        cache = dstate._mc_datalevels = {}
    key = tuple(comps)
    if key not in cache:
        coord_levels = _coord_levels(dstate)
        cache[key] = [jnp.concatenate(
            [coord_levels[lev], dstate.data[lev][np.asarray(comps)]], axis=0)
            for lev in range(dstate.meta.n_levels)]
    return cache[key]


def _coord_levels(dstate: DenseAmrState):
    """Per-level [3, *bbox] cell-center coordinate fields (cached on the
    state — rebuilt host meshgrids showed up in the isosurface profile)."""
    cached = getattr(dstate, "_mc_coords", None)
    if cached is not None:
        return cached
    out = []
    for lev in range(dstate.meta.n_levels):
        geom = dstate.meta.geoms[lev]
        bbox = dstate.lmeta[lev].bbox
        cs = [geom.prob_lo[d]
              + (np.arange(bbox.lo[d], bbox.hi[d] + 1)
                 - geom.domain.lo[d] + 0.5) * geom.dx[d] for d in range(3)]
        X, Y, Z = np.meshgrid(*cs, indexing="ij")
        out.append(jnp.asarray(np.stack([X, Y, Z]),
                               dstate.data[lev].dtype))
    dstate._mc_coords = out
    return out


def _grown_masks(dstate: DenseAmrState, lev: int):
    """Host masks on the grown bbox: (covered_by_finer, in_level_padded);
    static per hierarchy, cached on the state."""
    cache = getattr(dstate, "_mc_masks", None)
    if cache is None:
        cache = dstate._mc_masks = {}
    if lev in cache:
        return cache[lev]
    meta = dstate.meta
    gbox = dstate.lmeta[lev].bbox.grow(1)
    cov = np.zeros(gbox.shape, dtype=bool)
    if lev + 1 < meta.n_levels:
        r = meta.ref_ratio[lev]
        from ..amr.hierarchy import _periodic_shifts
        per = meta.geoms[lev].is_periodic
        dom = meta.geoms[lev].domain
        for fb in meta.bas[lev + 1].coarsen(r):
            for sh in _periodic_shifts(per, dom):
                isect = gbox.intersect(fb.shift(sh))
                if not isect.is_empty():
                    sl = tuple(slice(isect.lo[d] - gbox.lo[d],
                                     isect.hi[d] - gbox.lo[d] + 1)
                               for d in range(3))
                    cov[sl] = True
    inlev = np.pad(dstate.in_level_mask_np(lev), 1)
    cache[lev] = (cov, inlev)
    return cov, inlev


def _corner_keys_at(dstate: DenseAmrState, lev: int, inlev_p: np.ndarray,
                    ii: np.ndarray, jj: np.ndarray,
                    kk: np.ndarray) -> np.ndarray:
    """Packed (level, global cell) keys for the given grown-bbox cell
    indices; collapsed ghost/hole corners are keyed by their coarse parent.
    Computed only for the cells requested (the full-volume variant dominated
    the isosurface wall-clock)."""
    meta = dstate.meta
    geom = meta.geoms[lev]
    dom = geom.domain
    gbox = dstate.lmeta[lev].bbox.grow(1)
    G = []
    for d, loc in enumerate((ii, jj, kk)):
        raw = loc + gbox.lo[d] - dom.lo[d]
        if geom.is_periodic[d]:
            G.append(raw % dom.shape[d])
        else:
            G.append(np.clip(raw, 0, dom.shape[d] - 1))
    lev_arr = np.full(ii.shape, lev)
    fine_key = _pack_key(lev_arr, *G)
    if lev == 0:
        return fine_key
    r = meta.ref_ratio[lev - 1]
    dom_c = dom.coarsen(r)
    Gc = [np.floor_divide(G[d] + dom.lo[d], r) - dom_c.lo[d]
          for d in range(3)]
    crse_key = _pack_key(lev_arr - 1, *Gc)
    return np.where(inlev_p[ii, jj, kk], fine_key, crse_key)


@partial(jax.jit, static_argnames=())
def _classify(field_grown: jnp.ndarray, iso_val) -> jnp.ndarray:
    """cubeindex [S0-1,S1-1,S2-1] from the 8 corner signs (<isoVal => bit,
    isosurface.cpp:747-755)."""
    # uint8 arithmetic: the 8 shifted reads move 1/4 the bytes of int32
    # (this stage is HBM-bound; ci fits a byte by construction)
    inside = (field_grown < iso_val).astype(jnp.uint8)
    ci = None
    for b, (oi, oj, ok) in enumerate(np.asarray(CORNER_OFFSETS)):
        view = inside[oi: inside.shape[0] - 1 + oi,
                      oj: inside.shape[1] - 1 + oj,
                      ok: inside.shape[2] - 1 + ok]
        term = view * np.uint8(1 << b)
        ci = term if ci is None else ci + term
    return ci


_EDGE_CA = jnp.asarray(CORNER_OFFSETS[CORNER_PAIRS[:, 0]])  # [12,3]
_EDGE_CB = jnp.asarray(CORNER_OFFSETS[CORNER_PAIRS[:, 1]])


@partial(jax.jit, static_argnames=())
def _gather_used_edge_verts(grown: jnp.ndarray, ci_idx: jnp.ndarray,
                            cj_idx: jnp.ndarray, ck_idx: jnp.ndarray,
                            eid: jnp.ndarray, iso_val, iso_comp: int = 3):
    """Device phase 2: interpolate ONLY the edges referenced by the case
    table — (cell, edge) pairs (ci_idx.., eid [Nu]) -> evals [Nu, nf].
    The full grown arrays never leave HBM; the host receives just the
    per-used-edge vertex rows (the bits of edgeTable[case] are exactly the
    referenced edges)."""
    oa = _EDGE_CA[eid]                                   # [Nu,3]
    ob = _EDGE_CB[eid]
    A = grown[:, ci_idx + oa[:, 0], cj_idx + oa[:, 1], ck_idx + oa[:, 2]].T
    B = grown[:, ci_idx + ob[:, 0], cj_idx + ob[:, 1], ck_idx + ob[:, 2]].T
    fa = A[:, iso_comp]
    fb = B[:, iso_comp]
    denom = fb - fa
    t = jnp.where(jnp.abs(denom) > 1e-30,
                  (iso_val - fa) / jnp.where(denom == 0, 1.0, denom), 0.0)
    t = jnp.clip(t, 0.0, 1.0)
    return A + t[:, None] * (B - A)                      # [Nu, nf]


@jax.jit
def _classify_all_levels(grown_list, iso_val):
    return [_classify(g[3], iso_val).astype(jnp.uint8) for g in grown_list]


_EDGE_TABLE_DEV = jnp.asarray(EDGE_TABLE)


def _compact_indices(flat_bool: jnp.ndarray, size: int,
                     inc: Optional[jnp.ndarray] = None,
                     n: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Ascending indices of the set bits, padded with 0 — exactly
    ``jnp.nonzero(size=size, fill_value=0)[0]`` semantics, but built as a
    binary search of the inclusive cumsum; callers that already hold the
    cumsum (the enum engine's rank assignment) pass ``inc`` to skip even
    that."""
    if inc is None:
        inc = jnp.cumsum(flat_bool.astype(jnp.int32))
    if n is None:
        n = inc[-1]
    idx = jnp.searchsorted(inc, jnp.arange(1, size + 1, dtype=jnp.int32),
                           side="left")
    return jnp.where(jnp.arange(size) < n, idx, 0).astype(jnp.int32)


@jax.jit
def _active_counts(ci_list, ok_list):
    return [jnp.sum(ok & (_EDGE_TABLE_DEV[ci] != 0))
            for ci, ok in zip(ci_list, ok_list)]


@partial(jax.jit, static_argnames=("cap",))
def _active_cells(ci_dev, ok_dev, cap):
    """Flat indices + case values of active dual cells (padded to cap),
    plus the true count so callers can detect cap overflow."""
    af = (ok_dev & (_EDGE_TABLE_DEV[ci_dev] != 0)).ravel()
    idx = _compact_indices(af, cap)
    return idx, ci_dev.ravel()[idx], jnp.sum(af)


@partial(jax.jit, static_argnames=("caps",))
def _active_all_packed(ci_list, ok_list, caps):
    """Active-cell discovery for ALL levels packed into ONE int32 vector
    [counts | idx_0..idx_L | cia4_0..cia4_L] so the host needs a single
    device-to-host copy instead of one per level; case values ride 4-per-int32
    (they are uint8) to shrink the payload."""
    idxs, cias, counts = [], [], []
    for ci, ok, cap in zip(ci_list, ok_list, caps):
        af = (ok & (_EDGE_TABLE_DEV[ci] != 0)).ravel()
        idx = _compact_indices(af, cap)
        idxs.append(idx)
        c = ci.ravel()[idx].astype(jnp.int32)
        cias.append(c[0::4] | (c[1::4] << 8) | (c[2::4] << 16)
                    | (c[3::4] << 24))
        counts.append(jnp.sum(af).astype(jnp.int32))
    return jnp.concatenate([jnp.stack(counts)] + idxs + cias)


def _unpack_cia4(v: np.ndarray, cap: int) -> np.ndarray:
    out = np.empty(cap, np.int32)
    out[0::4] = v & 255
    out[1::4] = (v >> 8) & 255
    out[2::4] = (v >> 16) & 255
    out[3::4] = (v >> 24) & 255
    return out


def _pad_gran(n: int, gran: int = 4096, minimum: int = 4096) -> int:
    """Tight speculative capacity: next multiple of `gran` with ~10%
    headroom (pow2 padding wasted up to 2x of every fetch)."""
    m = int(n * 1.1) + gran - 1
    return max((m // gran) * gran, minimum)


@jax.jit
def _gather_rows_multi(used_list, ridx_list):
    """Per-level node-row gathers concatenated on device: one fetch total."""
    return jnp.concatenate([u[r] for u, r in zip(used_list, ridx_list)],
                           axis=0)


def _ok_mask_dev(dstate, lev):
    """iso-independent processability mask of dual cells, uploaded once per
    (state, level): no covered corner, touches the level, inside the
    (periodically grown) domain."""
    cache = getattr(dstate, "_mc_okdev", None)
    if cache is None:
        cache = dstate._mc_okdev = {}
    if lev in cache:
        return cache[lev]
    meta = dstate.meta
    geom = meta.geoms[lev]
    dom = geom.domain
    gbox = dstate.lmeta[lev].bbox.grow(1)
    cov, inlev_p = _grown_masks(dstate, lev)
    shp = tuple(s - 1 for s in cov.shape)
    ok = np.ones(shp, dtype=bool)
    touch = np.zeros(shp, dtype=bool)
    for o in np.asarray(CORNER_OFFSETS):
        win = tuple(slice(o[d], cov.shape[d] - 1 + o[d]) for d in range(3))
        ok &= ~cov[win]
        touch |= inlev_p[win]
    for d in range(3):
        base = np.arange(gbox.lo[d], gbox.hi[d])
        lo_ok = base >= (dom.lo[d] - 1 if geom.is_periodic[d] else dom.lo[d])
        hi_ok = base + 1 <= (dom.hi[d] + 1 if geom.is_periodic[d]
                             else dom.hi[d])
        sh = [1, 1, 1]
        sh[d] = -1
        ok &= (lo_ok & hi_ok).reshape(sh)
    cache[lev] = (jnp.asarray(ok & touch), shp)
    return cache[lev]


@jax.jit
def _gather_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    return table[idx]


# ---------------------------------------------------------------------------
# Fully fused on-device extraction: fill -> classify -> emit -> dedup in ONE
# jit dispatch, ONE packed fetch.  Node identity is the integer edge key as
# QUADS (lev, gx, gy, gz) x 2 corners = 8 x int32 (no int64 on device), and
# the exact sort-unique is lax.sort with num_keys=8 — the device analog of
# the host lexsort (improving on the reference's epsilon-ball Node::operator<,
# isosurface.cpp:834-873).
# ---------------------------------------------------------------------------
_TRI_TABLE_DEV = jnp.asarray(TRI_TABLE[:, :15].reshape(256, 5, 3))
_TRI_COUNT_DEV = jnp.asarray(TRI_COUNT)
# states above this cell count pay a counts-probe before the first big
# enum build (see extract_isosurface_enum); tests lower it to force the path
_PROBE_MIN_CELLS = 1 << 22

# jitted enum engines shared ACROSS DenseAmrState instances with the same
# hierarchy (fingerprint below): a repeated single-tool CLI run over a time
# series builds a fresh state per plotfile, and re-TRACING the 1500-line
# engine costs seconds per invocation.  Keyed by the full
# structural identity; LRU-capped.
_GLOBAL_ENUM_FNS = {}


def _enum_fn_shared(dstate, key, build):
    """Per-instance cache backed by the cross-instance one."""
    from ..amr.dense import shared_engine
    return shared_engine(_GLOBAL_ENUM_FNS, 32, dstate, key, build)
_PAIR_A = tuple(int(v) for v in CORNER_PAIRS[:, 0])
_PAIR_B = tuple(int(v) for v in CORNER_PAIRS[:, 1])
_I32MAX = np.int32(np.iinfo(np.int32).max)


def _lex_lt(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a < b lexicographically over the last axis."""
    lt = jnp.zeros(a.shape[:-1], bool)
    for d in range(a.shape[-1] - 1, -1, -1):
        lt = jnp.where(a[..., d] < b[..., d], True,
                       jnp.where(a[..., d] > b[..., d], False, lt))
    return lt


def _corner_quads_dev(ii, jj, kk, inlev_p, c):
    """(lev, gx, gy, gz) int32 quads for grown-bbox cell indices; collapsed
    ghost/hole corners keyed by their coarse parent (device version of
    _corner_keys_at)."""
    lev, gbox_lo, dom_lo, dom_shape, periodic, r, domc_lo = c
    G = []
    for d, loc in enumerate((ii, jj, kk)):
        raw = loc + (gbox_lo[d] - dom_lo[d])
        if periodic[d]:
            G.append((raw % dom_shape[d]).astype(jnp.int32))
        else:
            G.append(jnp.clip(raw, 0, dom_shape[d] - 1).astype(jnp.int32))
    fine = jnp.stack([jnp.full_like(G[0], lev + 1)] + G, axis=-1)
    if lev == 0:
        return fine
    Gc = [((G[d] + dom_lo[d]) // r - domc_lo[d]).astype(jnp.int32)
          for d in range(3)]
    crse = jnp.stack([jnp.full_like(G[0], lev)] + Gc, axis=-1)
    return jnp.where(inlev_p[ii, jj, kk][..., None], fine, crse)


def _emit_level_fused(grown, ok, inlev_p, iso_val, cap, c, iso_comp):
    """One level's triangles, fully on device.  Returns
    (verts [cap,12,nf], tri_keys [cap*5,3,8], tri_rows [cap*5,3] level-local,
    tri_valid [cap*5], n_active)."""
    ci = _classify(grown[iso_comp], iso_val)
    shp = ci.shape
    af = (ok & (_EDGE_TABLE_DEV[ci] != 0)).ravel()
    n = jnp.sum(af)
    idx = _compact_indices(af, cap, n=n)
    live = (jnp.arange(cap) < n)
    ai, aj, ak = jnp.unravel_index(idx, shp)
    cia = ci.ravel()[idx]

    quads = []                                           # 8 x [cap,4]
    cvals = []                                           # 8 x [nf,cap]
    for o in np.asarray(CORNER_OFFSETS):
        ii, jj, kk = ai + o[0], aj + o[1], ak + o[2]
        quads.append(_corner_quads_dev(ii, jj, kk, inlev_p, c))
        cvals.append(grown[:, ii, jj, kk])
    qk = jnp.stack(quads, axis=1)                        # [cap,8,4]
    cv = jnp.stack(cvals, axis=2)                        # [nf,cap,8]

    ka = qk[:, np.asarray(_PAIR_A)]                      # [cap,12,4]
    kb = qk[:, np.asarray(_PAIR_B)]
    a_first = _lex_lt(ka, kb)[..., None]
    ekey = jnp.concatenate([jnp.where(a_first, ka, kb),
                            jnp.where(a_first, kb, ka)], axis=-1)  # [cap,12,8]

    A = cv[:, :, np.asarray(_PAIR_A)]                    # [nf,cap,12]
    B = cv[:, :, np.asarray(_PAIR_B)]
    fa, fb = A[iso_comp], B[iso_comp]                    # [cap,12]
    denom = fb - fa
    t = jnp.where(jnp.abs(denom) > 1e-30,
                  (iso_val - fa) / jnp.where(denom == 0, 1.0, denom), 0.0)
    t = jnp.clip(t, 0.0, 1.0)
    verts = jnp.moveaxis(A + t[None] * (B - A), 0, -1)   # [cap,12,nf]

    tri_e = _TRI_TABLE_DEV[cia]                          # [cap,5,3]
    tri_valid = ((tri_e[..., 0] >= 0) & live[:, None]).ravel()  # [cap*5]
    e_safe = jnp.maximum(tri_e, 0)
    tri_keys = ekey[jnp.arange(cap)[:, None, None], e_safe]     # [cap,5,3,8]
    tri_rows = (jnp.arange(cap, dtype=jnp.int32)[:, None, None] * 12
                + e_safe.astype(jnp.int32))                     # [cap,5,3]
    return (verts, tri_keys.reshape(cap * 5, 3, 8),
            tri_rows.reshape(cap * 5, 3), tri_valid, n)


def _pack_result(nodes, elements, counts):
    """Single int32 vector: [counts | elements | bitcast(nodes)]."""
    nb = jax.lax.bitcast_convert_type(nodes, jnp.int32)
    return jnp.concatenate([jnp.asarray(counts, jnp.int32).ravel(),
                            elements.astype(jnp.int32).ravel(),
                            nb.ravel()])


def _build_fused_fn(meta, lmeta, consts, bc, nf, iso_comp, caps,
                    node_cap, tri_cap, unwraps):
    """Jitted fill->classify->emit->dedup over the whole hierarchy."""
    n_levels = meta.n_levels

    def fn(data_levels, mask_list, inlev_devs, ok_devs, iso_val):
        grown = fill_dense_multilevel(meta, lmeta, data_levels, mask_list,
                                      1, bc, "pc")
        # periodic unwrap of ghost-ring coordinates (isosurface.cpp:1482-1507)
        unwrapped = []
        for lev, g in enumerate(grown):
            for (sl, dv) in unwraps[lev]:
                g = g.at[sl].add(dv)
            unwrapped.append(g)

        verts_all, tk_all, tr_all, tv_all, ns = [], [], [], [], []
        row_off = 0
        for lev in range(n_levels):
            v, tk, tr, tv, n = _emit_level_fused(
                unwrapped[lev], ok_devs[lev], inlev_devs[lev], iso_val,
                caps[lev], consts[lev], iso_comp)
            verts_all.append(v.reshape(-1, nf))
            tk_all.append(tk)
            tr_all.append(tr + row_off)
            tv_all.append(tv)
            ns.append(n)
            row_off += caps[lev] * 12

        verts = jnp.concatenate(verts_all)               # [sum cap*12, nf]
        TK = jnp.concatenate(tk_all)                     # [T,3,8]
        TR = jnp.concatenate(tr_all)                     # [T,3]
        TV = jnp.concatenate(tv_all)                     # [T]
        T = TK.shape[0]
        N = T * 3
        flatK = TK.reshape(N, 8)
        flatR = TR.reshape(N)
        flatV = jnp.repeat(TV, 3)
        keyK = jnp.where(flatV[:, None], flatK, _I32MAX)
        ops = tuple(keyK[:, d] for d in range(8)) \
            + (jnp.arange(N, dtype=jnp.int32),)
        sorted_ops = jax.lax.sort(ops, num_keys=8, is_stable=True)
        sk = jnp.stack(sorted_ops[:8], axis=-1)          # [N,8]
        perm = sorted_ops[8]
        new = jnp.concatenate([jnp.ones(1, bool),
                               jnp.any(sk[1:] != sk[:-1], axis=1)])
        newv = new & flatV[perm]
        gid = jnp.cumsum(newv.astype(jnp.int32)) - 1
        inv = jnp.zeros(N, jnp.int32).at[perm].set(gid)
        n_uniq = jnp.sum(newv)
        firstpos = _compact_indices(newv, node_cap,
                                    inc=gid + 1, n=n_uniq)
        nodes = verts[flatR[perm[firstpos]]]             # [node_cap, nf]
        n_tri = jnp.sum(TV)
        tri_idx = _compact_indices(TV, tri_cap, n=n_tri)
        elements = inv.reshape(T, 3)[tri_idx]            # [tri_cap,3]
        counts = jnp.concatenate([jnp.stack([n_uniq, n_tri]).astype(jnp.int32),
                                  jnp.stack(ns).astype(jnp.int32)])
        return _pack_result(nodes, elements, counts)

    return jax.jit(fn)


def _pad_pow2(n: int, minimum: int = 256) -> int:
    m = minimum
    while m < n:
        m *= 2
    return m


# ---------------------------------------------------------------------------
# "enum" engine: sort-free single-dispatch single-fetch extraction.
#
# Node identity is CANONICAL instead of deduplicated: every node lies on a
# unique dual-grid edge (cell c, axis a) — the edge's lower-corner cell in the
# grown volume plus its direction.  A full-volume crossing mask
# (inside(c) ^ inside(c+e_a)) enumerates all candidate nodes; "referenced"
# restricts to edges adjacent to an emitting dual cell (for an active cell
# every crossed edge is used — a property of the marching-cubes tables); an
# exclusive cumsum over the referenced flags assigns node ids with NO sort
# (a device sort dominates the fused engine).  Cross-level
# seam identification (the reference's collapsed-ghost dedup,
# isosurface.cpp:834-873 + 1450-1479) maps ghost-ghost fine edges to their
# coarse parent edge: the coarse crossing mask sees the identical values (pc
# fill), so marking the coarse edge referenced reproduces the watertight join
# exactly.  Periodic level-0 images fold onto their primary slots.
#
# Known deviation: at periodic seams the surviving node instance is the
# primary-image one (coordinates not unwrapped to the ghost side), where the
# dedup engines keep the first emission's coordinates; the surfaces differ
# only by ±domain-length in the periodic coordinate of seam nodes.
# ---------------------------------------------------------------------------
_E_AXIS = np.array([int(np.argmax(np.abs(CORNER_OFFSETS[b] - CORNER_OFFSETS[a])))
                    for a, b in np.asarray(CORNER_PAIRS)])
_E_LOWER = np.minimum(CORNER_OFFSETS[CORNER_PAIRS[:, 0]],
                      CORNER_OFFSETS[CORNER_PAIRS[:, 1]])      # [12,3]


def _corner_index_of(off) -> int:
    for i, o in enumerate(np.asarray(CORNER_OFFSETS)):
        if (o == off).all():
            return i
    raise AssertionError


_E_LO_CORNER = np.array([_corner_index_of(_E_LOWER[e]) for e in range(12)])
_E_HI_CORNER = np.array([_corner_index_of(
    _E_LOWER[e] + np.eye(3, dtype=int)[_E_AXIS[e]]) for e in range(12)])


def _dilate_active(act: jnp.ndarray, a: int) -> jnp.ndarray:
    """OR of the <=4 dual cells containing each axis-a edge.  act: [S-1]^3
    (dual cells); result matches the axis-a edge volume shape (S-1 along a,
    S along the others)."""
    pads = [(0, 0) if d == a else (1, 1) for d in range(3)]
    P = jnp.pad(act, pads)
    out = None
    others = [d for d in range(3) if d != a]
    for ob in (0, 1):
        for og in (0, 1):
            sl = [slice(None)] * 3
            sl[others[0]] = slice(ob, P.shape[others[0]] - 1 + ob)
            sl[others[1]] = slice(og, P.shape[others[1]] - 1 + og)
            w = P[tuple(sl)]
            out = w if out is None else (out | w)
    return out


def _edge_crossed(inside: jnp.ndarray, a: int) -> jnp.ndarray:
    sl0 = [slice(None)] * 3
    sl1 = [slice(None)] * 3
    sl0[a] = slice(0, inside.shape[a] - 1)
    sl1[a] = slice(1, inside.shape[a])
    return inside[tuple(sl0)] ^ inside[tuple(sl1)]


def _ghost_pair(ghost: jnp.ndarray, a: int) -> jnp.ndarray:
    sl0 = [slice(None)] * 3
    sl1 = [slice(None)] * 3
    sl0[a] = slice(0, ghost.shape[a] - 1)
    sl1[a] = slice(1, ghost.shape[a])
    return ghost[tuple(sl0)] & ghost[tuple(sl1)]


def _fold_edge_mask(m: jnp.ndarray, a: int, spans) -> jnp.ndarray:
    """Fold periodic image slots onto their primaries and zero the images.
    spans[d] = (True, N) when the grown volume wraps the domain along d."""
    for d in range(3):
        span, N = spans[d]
        if not span:
            continue
        ext = m.shape[d]

        def sl(i):
            s = [slice(None)] * 3
            s[d] = slice(i, i + 1)
            return tuple(s)

        m = m.at[sl(N)].max(m[sl(0)])
        m = m.at[sl(0)].set(False)
        if ext > N + 1:                      # non-edge axis has slot N+1
            m = m.at[sl(1)].max(m[sl(N + 1)])
            m = m.at[sl(N + 1)].set(False)
    return m


def _fold_rank_vol(r: jnp.ndarray, a: int, spans) -> jnp.ndarray:
    """Overwrite image slots of a rank volume with their primary ranks so
    lookups need no coordinate remap."""
    for d in range(3):
        span, N = spans[d]
        if not span:
            continue
        ext = r.shape[d]

        def sl(i):
            s = [slice(None)] * 3
            s[d] = slice(i, i + 1)
            return tuple(s)

        r = r.at[sl(0)].set(r[sl(N)])
        if ext > N + 1:
            r = r.at[sl(N + 1)].set(r[sl(1)])
    return r


def _coarsen_edge_mask(m: jnp.ndarray, a: int, r: int, gbox_lo, cshape,
                       cgbox_lo):
    """ANY-reduce a fine edge mask onto coarse edge slots (r-block per axis,
    aligned on global coordinates).  Returns (coarse-shaped array, slices)
    for OR-insertion, or None when out of range."""
    out = m
    starts = []
    for d in range(3):
        lo_g = gbox_lo[d]
        pad_lo = lo_g % r
        size = out.shape[d]
        pad_hi = (-(pad_lo + size)) % r
        pads = [(0, 0)] * 3
        pads[d] = (pad_lo, pad_hi)
        out = jnp.pad(out, pads)
        newshape = list(out.shape)
        U = newshape[d] // r
        newshape[d] = U
        newshape.insert(d + 1, r)
        out = out.reshape(newshape).any(axis=d + 1)
        starts.append((lo_g - pad_lo) // r - cgbox_lo[d])
    slices = []
    for d in range(3):
        s0 = starts[d]
        s1 = s0 + out.shape[d]
        if s0 < 0 or s1 > cshape[d]:
            # clip (proper nesting should prevent this; clip keeps us safe)
            lo_clip = max(0, -s0)
            hi_clip = max(0, s1 - cshape[d])
            sl = [slice(None)] * 3
            sl[d] = slice(lo_clip, out.shape[d] - hi_clip)
            out = out[tuple(sl)]
            s0, s1 = s0 + lo_clip, s1 - hi_clip
        slices.append(slice(s0, s1))
    return out, tuple(slices)


def _build_enum_fn(meta, lmeta, consts, bc, nf, iso_comp, caps, node_caps,
                   tri_cap, unwraps, spans_all, emit_levels=None,
                   want_eids=False, counts_only=False, wide_tris=False):
    """Jitted fill->classify->enumerate->emit over the whole hierarchy;
    returns ONE packed int32 vector
    [counts | elements | (eids) | bitcast(nodes)].
    counts = [n_nodes_tot, n_tri, n_act per emit level...,
              n_nodes per level..., n_tri per emit level...].
    emit_levels restricts TRIANGLE emission (nodes always enumerate on every
    level — the sparse per-cluster path emits fine triangles per run but
    needs the shared coarse node identities); want_eids ships each node's
    canonical (level-local flat) edge id for exact cross-run merging."""
    n_levels = meta.n_levels
    if emit_levels is None:
        emit_levels = tuple(range(n_levels))
    rr = [meta.ref_ratio[lev - 1] if lev > 0 else 1
          for lev in range(n_levels)]
    gbox_los = [tuple(lmeta[lev].bbox.grow(1).lo) for lev in range(n_levels)]

    def fn(data_levels, mask_list, inlev_devs, ok_devs, iso_val):
        grown = fill_dense_multilevel(meta, lmeta, data_levels, mask_list,
                                      1, bc, "pc")
        unwrapped = []
        for lev, g in enumerate(grown):
            for (sl, dv) in unwraps[lev]:
                g = g.at[sl].add(dv)
            unwrapped.append(g)

        # --- per-level crossing / active / dilation masks -------------------
        refs = [[None] * 3 for _ in range(n_levels)]
        acts, cis = [], []
        for lev in range(n_levels):
            G = unwrapped[lev]
            inside = G[iso_comp] < iso_val
            ci = _classify(G[iso_comp], iso_val)
            act = ok_devs[lev] & (_EDGE_TABLE_DEV[ci] != 0)
            acts.append(act)
            cis.append(ci)
            ghost = ~inlev_devs[lev]
            for a in range(3):
                crossed = _edge_crossed(inside, a)
                if lev not in emit_levels:
                    # emit-restricted (sparse cluster) run: a non-emitted
                    # coarse level enumerates ONLY the class-B seam parents
                    # finer levels inject below — its own crossing refs are
                    # merge-dedup fodder at best, and at a middle level's
                    # window pad ring they are JUNK: the ring holds
                    # coarse-upsampled values where the global run has real
                    # mid-level data, so ring refs/positions disagree with
                    # the dense run (measured: 42 bogus/corrupt seam nodes
                    # on a 3-level scattered case; the colliding keys also
                    # overwrote correct coarse-pass node positions in the
                    # cross-run merge)
                    z = jnp.zeros(crossed.shape, bool)
                    refs[lev][a] = (z, z if lev > 0 else None)
                    continue
                dil = _dilate_active(act, a)
                ref = crossed & dil
                if lev > 0:
                    gp = _ghost_pair(ghost, a)
                    refs[lev][a] = (ref & ~gp, ref & gp)
                else:
                    refs[lev][a] = (ref, None)

        # --- inject class-B (ghost-ghost) seam edges into the coarse level --
        for lev in range(n_levels - 1, 0, -1):
            for a in range(3):
                refA, refB = refs[lev][a]
                refB = _fold_edge_mask(refB, a, spans_all[lev])
                cshape = refs[lev - 1][a][0].shape
                co, slc = _coarsen_edge_mask(refB, a, rr[lev], gbox_los[lev],
                                             cshape, gbox_los[lev - 1])
                base, extra = refs[lev - 1][a]
                base = base.at[slc].max(co)
                refs[lev - 1][a] = (base, extra)
                refs[lev][a] = (refA, None)

        # --- fold periodic images, assign global ranks ----------------------
        ref_final = []
        for lev in range(n_levels):
            ref_final.append([
                _fold_edge_mask(refs[lev][a][0], a, spans_all[lev])
                for a in range(3)])

        flat_levels = [jnp.concatenate([ref_final[lev][a].ravel()
                                        for a in range(3)])
                       for lev in range(n_levels)]
        n_nodes_lev = [jnp.sum(f).astype(jnp.int32) for f in flat_levels]

        if counts_only:
            # capacity probe: exact per-level active/node counts + the
            # exact triangle total WITHOUT the gather/emission phases —
            # a much smaller graph that compiles fast, so the big engine
            # compiles ONCE with the right caps instead of re-compiling
            # through the adaptation loop (the r3 cold-compile lever)
            n_act = [jnp.sum(acts[lev]).astype(jnp.int32)
                     for lev in emit_levels]
            n_tri = sum(
                jnp.sum(jnp.where(acts[lev], _TRI_COUNT_DEV[cis[lev]], 0))
                for lev in emit_levels).astype(jnp.int32)
            return jnp.concatenate(
                [jnp.stack(n_act),
                 jnp.stack(n_nodes_lev).astype(jnp.int32), n_tri[None]])
        rank_vols = []
        inc_levels = []                     # inclusive cumsums, reused by the
        offset = jnp.asarray(0, jnp.int32)  # node compaction searchsorted
        for lev in range(n_levels):
            f = flat_levels[lev].astype(jnp.int32)
            inc = jnp.cumsum(f)
            inc_levels.append(inc)
            cs = inc - f + offset                    # exclusive + offset
            offset = offset + n_nodes_lev[lev]
            vols, p = [], 0
            for a in range(3):
                sz = int(np.prod(ref_final[lev][a].shape))
                v = cs[p: p + sz].reshape(ref_final[lev][a].shape)
                vols.append(_fold_rank_vol(v, a, spans_all[lev]))
                p += sz
            rank_vols.append(vols)
        n_nodes_tot = offset

        # --- node rows: interpolate at referenced crossings ------------------
        node_rows = []
        node_eids = []
        for lev in range(n_levels):
            G = unwrapped[lev]
            cap = node_caps[lev]
            shapes = [ref_final[lev][a].shape for a in range(3)]
            sz = [int(np.prod(s)) for s in shapes]
            off = [0, sz[0], sz[0] + sz[1]]
            nidx = _compact_indices(flat_levels[lev], cap,
                                    inc=inc_levels[lev],
                                    n=n_nodes_lev[lev])
            node_eids.append(nidx)
            ax = ((nidx >= off[1]).astype(jnp.int32)
                  + (nidx >= off[2]).astype(jnp.int32))
            cA = []
            for d in range(3):
                vs = []
                for a in range(3):
                    loc = jnp.clip(nidx - off[a], 0, sz[a] - 1)
                    s = shapes[a]
                    if d == 0:
                        vs.append(loc // (s[1] * s[2]))
                    elif d == 1:
                        vs.append((loc // s[2]) % s[1])
                    else:
                        vs.append(loc % s[2])
                cA.append(jnp.where(ax == 0, vs[0],
                                    jnp.where(ax == 1, vs[1], vs[2])))
            cB = [cA[d] + (ax == d) for d in range(3)]
            # one gather for both edge endpoints (per-op gather cost)
            AB = G[:, jnp.concatenate([cA[0], cB[0]]),
                   jnp.concatenate([cA[1], cB[1]]),
                   jnp.concatenate([cA[2], cB[2]])]   # [nf, 2*cap]
            A, B = AB[:, :cap], AB[:, cap:]
            fa, fb = A[iso_comp], B[iso_comp]
            denom = fb - fa
            t = jnp.where(jnp.abs(denom) > 1e-30,
                          (iso_val - fa) / jnp.where(denom == 0, 1.0, denom),
                          0.0)
            t = jnp.clip(t, 0.0, 1.0)
            row = (A + t[None] * (B - A)).T               # [cap, nf]
            # the iso component interpolates to iso_val by construction —
            # don't fetch it; the host re-inserts the column
            node_rows.append(jnp.concatenate(
                [row[:, :iso_comp], row[:, iso_comp + 1:]], axis=1))
        nodes = jnp.concatenate(node_rows)

        # --- elements: active cells -> per-edge canonical node ids ----------
        tri_nid_all, tri_valid_all, ns, tri_ns = [], [], [], []
        for lev in emit_levels:
            cap = caps[lev]
            act = acts[lev]
            shp = act.shape
            af = act.ravel()
            n = jnp.sum(af)
            ns.append(n)
            idx = _compact_indices(af, cap, n=n)
            live = (jnp.arange(cap) < n)
            ai = idx // (shp[1] * shp[2])
            aj = (idx // shp[2]) % shp[1]
            ak = idx % shp[2]
            cia = cis[lev].ravel()[idx]

            # consolidate the 8 corner-flag gathers into one and the 12/24
            # per-edge rank-volume gathers into one per rank volume (3 fine
            # + 3 coarse) — same values, ~10x fewer gather ops on the
            # engine's hot path
            si = inlev_devs[lev].shape
            fl8 = jnp.concatenate(
                [((ai + int(o[0])) * si[1] + (aj + int(o[1]))) * si[2]
                 + (ak + int(o[2])) for o in np.asarray(CORNER_OFFSETS)])
            gf_all = inlev_devs[lev].ravel()[fl8]
            gf = [gf_all[b * cap:(b + 1) * cap] for b in range(8)]

            edges_by_axis = [[e for e in range(12) if int(_E_AXIS[e]) == a]
                             for a in range(3)]
            nid_of_e = [None] * 12
            for a in range(3):
                es = edges_by_axis[a]
                s = ref_final[lev][a].shape
                ffs = []
                for e in es:
                    lo = _E_LOWER[e]
                    c = (ai + int(lo[0]), aj + int(lo[1]), ak + int(lo[2]))
                    ffs.append((c[0] * s[1] + c[1]) * s[2] + c[2])
                nid_f = rank_vols[lev][a].ravel()[jnp.concatenate(ffs)]
                if lev > 0:
                    r = rr[lev]
                    sc = ref_final[lev - 1][a].shape
                    fcs = []
                    for e in es:
                        lo = _E_LOWER[e]
                        c = (ai + int(lo[0]), aj + int(lo[1]),
                             ak + int(lo[2]))
                        u = [jnp.floor_divide(c[d] + gbox_los[lev][d], r)
                             - gbox_los[lev - 1][d] for d in range(3)]
                        u = [jnp.clip(u[d], 0, sc[d] - 1) for d in range(3)]
                        fcs.append((u[0] * sc[1] + u[1]) * sc[2] + u[2])
                    nid_c = rank_vols[lev - 1][a].ravel()[
                        jnp.concatenate(fcs)]
                    for i, e in enumerate(es):
                        classB = (~gf[int(_E_LO_CORNER[e])]
                                  & ~gf[int(_E_HI_CORNER[e])])
                        nid_of_e[e] = jnp.where(
                            classB, nid_c[i * cap:(i + 1) * cap],
                            nid_f[i * cap:(i + 1) * cap])
                else:
                    for i, e in enumerate(es):
                        nid_of_e[e] = nid_f[i * cap:(i + 1) * cap]
            nid12 = jnp.stack(nid_of_e, axis=1)       # [cap,12]

            tri_e = _TRI_TABLE_DEV[cia]               # [cap,5,3]
            tri_valid = ((tri_e[..., 0] >= 0) & live[:, None])
            e_safe = jnp.maximum(tri_e, 0)
            tri_nid = nid12[jnp.arange(cap)[:, None, None], e_safe]
            tri_nid_all.append(tri_nid.reshape(cap * 5, 3))
            tri_valid_all.append(tri_valid.ravel())
            tri_ns.append(jnp.sum(tri_valid).astype(jnp.int32))

        TN = jnp.concatenate(tri_nid_all)
        TV = jnp.concatenate(tri_valid_all)
        n_tri = jnp.sum(TV)
        tri_idx = _compact_indices(TV, tri_cap, n=n_tri)
        elements = TN[tri_idx]
        if wide_tris:
            # full-width ids: 3 int32 words per triangle — no node-count
            # ceiling (surfaces past 2^21 nodes re-dispatch with this)
            epacked = elements
        else:
            # 3 node ids -> 2 int32 words (21 bits each; n_nodes < 2^21
            # checked host-side via counts, auto-retried wide) — the
            # element payload is the largest fetch chunk; this shaves a
            # third off it
            e0, e1, e2 = elements[:, 0], elements[:, 1], elements[:, 2]
            w0 = e0 | ((e1 & 0x7FF) << 21)
            w1 = (e1 >> 11) | (e2 << 10)
            epacked = jnp.stack([w0, w1], axis=1)

        counts = jnp.concatenate(
            [jnp.stack([n_nodes_tot, n_tri]).astype(jnp.int32),
             jnp.stack(ns).astype(jnp.int32),
             jnp.stack(n_nodes_lev).astype(jnp.int32),
             jnp.stack(tri_ns).astype(jnp.int32)])
        nb = jax.lax.bitcast_convert_type(nodes, jnp.int32)
        parts = [counts, epacked.astype(jnp.int32).ravel()]
        if want_eids:
            parts.append(jnp.concatenate(node_eids))
        parts.append(nb.ravel())
        return jnp.concatenate(parts)

    return jax.jit(fn)


class DeferredSurface:
    """Device-resident enum-engine surface (pipeline mode): the packed
    result vector stays on device; only the count header was fetched.
    ``positions()`` fetches the node xyz columns alone (a fraction of the
    full payload); ``to_mef()`` fetches and decodes everything (cached).
    Duck-types the MEF surface for downstream stages (positions/elements/
    names/n_nodes/n_elts)."""

    def __init__(self, packed_dev, decode_kw, counts, xyz_rows=None):
        self._packed = packed_dev
        self._kw = decode_kw
        self._mef = None
        self._xyz = None
        self._xyz_rows = xyz_rows    # cap-padded f32 rows, pre-fetched
        self.n_nodes = int(counts[0])
        self.n_elts = int(counts[1])
        self.names = ["X", "Y", "Z"] + list(decode_kw["names"])

    def positions(self) -> np.ndarray:
        if self._mef is not None:
            return self._mef.positions()
        if self._xyz is None:
            kw = self._kw
            self._xyz = _valid_node_rows(self._xyz_rows, kw["node_caps"],
                                         kw["n_nod"], 3)
        return np.asarray(self._xyz, np.float64)

    def to_mef(self) -> MEF:
        if self._mef is None:
            self._mef = _decode_packed(np.asarray(self._packed),
                                       **self._kw)[0]
            self._packed = None      # free the device buffer (it can be
            #                          tens of MB of HBM per surface)
        return self._mef

    @property
    def elements(self) -> np.ndarray:
        return self.to_mef().elements

    @property
    def nodes(self) -> np.ndarray:
        return self.to_mef().nodes


def _valid_node_rows(rows, node_caps, n_nod, width):
    """Slice the TRUE per-level prefixes out of cap-padded node rows."""
    parts, p = [], 0
    for lev in range(len(node_caps)):
        parts.append(rows[p: p + n_nod[lev]])
        p += node_caps[lev]
    return (np.concatenate(parts) if parts
            else np.zeros((0, width), rows.dtype if hasattr(rows, "dtype")
                          else np.float64))


def _decode_packed(packed: np.ndarray, *, nl, ne, node_caps, tri_cap,
                   want_eids, words, nf, names, iso_val, label, lmeta,
                   n_nod, n_tri, wide_tris=False):
    """Host-side decode of the enum engine's packed result vector."""
    base = 2 + ne + nl + ne
    tw = 3 if wide_tris else 2
    if wide_tris:
        elements = packed[base: base + tri_cap * 3].reshape(
            tri_cap, 3)[:n_tri]
    else:
        ep = packed[base: base + tri_cap * 2].reshape(tri_cap, 2)[:n_tri]
        w0, w1 = ep[:, 0], ep[:, 1]
        elements = np.stack([w0 & 0x1FFFFF,
                             (w0 >> 21) & 0x7FF | (w1 & 0x3FF) << 11,
                             (w1 >> 10) & 0x1FFFFF], axis=1)
    base += tri_cap * tw
    node_lev = node_eid = None
    if want_eids:
        # decode the level-local flat edge ids into GLOBAL packed keys
        # (lev, axis, global cell): local volume coords are cluster-relative
        # in the sparse path, so the merge key must be global
        eid_rows = packed[base: base + sum(node_caps)]
        base += sum(node_caps)
        eparts, lparts, p = [], [], 0
        for lev in range(nl):
            loc = eid_rows[p: p + n_nod[lev]].astype(np.int64)
            p += node_caps[lev]
            gbox = lmeta[lev].bbox.grow(1)
            gs = gbox.shape
            shapes = [tuple(gs[d] - (1 if d == a else 0) for d in range(3))
                      for a in range(3)]
            sz = [int(np.prod(s)) for s in shapes]
            ax = ((loc >= sz[0]).astype(np.int64)
                  + (loc >= sz[0] + sz[1]).astype(np.int64))
            off = np.asarray([0, sz[0], sz[0] + sz[1]])[ax]
            rel = loc - off
            key = np.zeros(len(loc), np.int64)
            for a in range(3):
                s = shapes[a]
                i = rel // (s[1] * s[2]) + gbox.lo[0] + 1
                j = (rel // s[2]) % s[1] + gbox.lo[1] + 1
                k = rel % s[2] + gbox.lo[2] + 1
                ka = (np.int64(lev) << 59 | np.int64(a) << 57
                      | i << 38 | j << 19 | k)
                key = np.where(ax == a, ka, key)
            eparts.append(key)
            lparts.append(np.full(n_nod[lev], lev, np.int32))
        node_eid = (np.concatenate(eparts) if eparts
                    else np.zeros(0, np.int64))
        node_lev = (np.concatenate(lparts) if lparts
                    else np.zeros(0, np.int32))
    nbits = packed[base:]
    rows = nbits.view(np.float64 if words == 2
                      else np.float32).reshape(sum(node_caps), nf - 1)
    # valid node rows are per-level cap-padded prefixes; global node ids are
    # dense ranks over the TRUE per-level counts -> slice and concatenate
    shipped = _valid_node_rows(rows, node_caps, n_nod, nf - 1)
    nodes = np.empty((len(shipped), nf), shipped.dtype)
    nodes[:, :3] = shipped[:, :3]
    nodes[:, 3] = iso_val                  # iso comp re-inserted (comp 3)
    nodes[:, 4:] = shipped[:, 3:]
    if sum(n_nod) == 0:
        nodes = np.zeros((0, nf))
        elements = np.zeros((0, 3), np.int32)
    mef = MEF(label or "0", ["X", "Y", "Z"] + list(names),
              np.asarray(nodes, np.float64),
              np.asarray(elements, np.int32))
    return mef, node_lev, node_eid


@partial(jax.jit, static_argnames=("node_caps", "tri_cap", "ne", "nl",
                                  "want_eids", "words", "nfm1", "tri_words"))
def _xyz_slice(packed, node_caps, tri_cap, ne, nl, want_eids, words, nfm1,
               tri_words=2):
    """Device slice of the packed vector down to the node xyz columns
    (cap-padded rows; host slices the valid prefixes)."""
    base = 2 + ne + nl + ne + tri_cap * tri_words
    if want_eids:
        base += sum(node_caps)
    nbits = packed[base:].reshape(sum(node_caps), nfm1 * words)
    if words == 2:
        rows = jax.lax.bitcast_convert_type(
            nbits.reshape(sum(node_caps), nfm1, 2), jnp.float64)
    else:
        rows = jax.lax.bitcast_convert_type(nbits, jnp.float32)
    return rows[:, :3]


@partial(jax.jit, static_argnames=("node_caps", "tri_cap", "ne", "nl",
                                  "want_eids", "words", "nfm1", "tri_words"))
def _head_xyz(packed, node_caps, tri_cap, ne, nl, want_eids, words, nfm1,
              tri_words=2):
    """Count header + bitcast node xyz columns as ONE int32 vector — one
    device-to-host copy covers both the cap check and the seed positions a
    downstream stream stage needs.
    xyz ships in the state's native float width (exactness preserved)."""
    head = packed[: 2 + ne + nl + ne]
    xyz = _xyz_slice(packed, node_caps, tri_cap, ne, nl, want_eids, words,
                     nfm1, tri_words)
    xb = jax.lax.bitcast_convert_type(xyz, jnp.int32)
    return jnp.concatenate([head, xb.reshape(-1)])


def _enum_prep(dstate: DenseAmrState, names, bc):
    """Shared device-input prep for the enum engine (also used by the
    sparse driver's counts probe)."""
    meta = dstate.meta
    comps = [dstate.comp(n) for n in names]
    data_levels = _data_levels_cached(dstate, comps)
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]
    ok_devs = [_ok_mask_dev(dstate, lev)[0] for lev in range(meta.n_levels)]
    inlev_devs = getattr(dstate, "_mc_inlev_dev", None)
    if inlev_devs is None:
        inlev_devs = dstate._mc_inlev_dev = [
            jnp.asarray(_grown_masks(dstate, lev)[1])
            for lev in range(meta.n_levels)]
    consts, unwraps = _fused_consts(dstate)
    spans_all = []
    for lev in range(meta.n_levels):
        geom = meta.geoms[lev]
        bbox = dstate.lmeta[lev].bbox
        # a dim "spans" when the level covers the whole periodic domain so
        # seam nodes must fold.  A bucket/mesh-PADDED level 0 (pad_state_to:
        # lo-aligned, hi-side pads) still spans: the grown arrays index from
        # domain.lo-1 exactly as unpadded, pad slots carry wrap values (the
        # fills re-grow from the true edge), and the ok-mask keeps dual
        # cells beyond domain.hi+1 inactive — so the slot-0/N and 1/N+1 fold
        # arithmetic is unchanged (tests/test_padded_lev0.py pins parity)
        spans_all.append(tuple(
            (bool(geom.is_periodic[d])
             and bbox.lo[d] == geom.domain.lo[d]
             and bbox.hi[d] >= geom.domain.hi[d],
             geom.domain.shape[d]) for d in range(3)))
    return (data_levels, masks, ok_devs, inlev_devs, consts, unwraps,
            tuple(spans_all))


@jax.jit
def _probe_max(vecs):
    """Elementwise max over per-cluster probe-count vectors (module-level
    jit — cached per cluster count)."""
    return jnp.max(jnp.stack(vecs), axis=0)


def enum_probe_counts(dstate: DenseAmrState, iso_name: str, iso_val: float,
                      extra_names: Sequence[str] = (), bc=None,
                      emit_levels=None, fetch: bool = True):
    """Counts-only probe: exact per-level active/node counts + triangle
    total from the small (fast-compiling) counts graph.  The sparse driver
    probes every cluster with ONE shared engine, then pins every cluster's
    caps to the maxima so the big engine compiles once.  fetch=False
    returns the DEVICE vector instead of numpy — callers probing many
    clusters dispatch them all and reduce on device (one roundtrip total
    instead of one per cluster)."""
    meta = dstate.meta
    names = [iso_name] + [n for n in extra_names if n != iso_name]
    if bc is None:
        bc = default_bc(3)
    nf = 3 + len(names)
    (data_levels, masks, ok_devs, inlev_devs, consts, unwraps,
     spans_all) = _enum_prep(dstate, names, bc)
    emit = (tuple(range(meta.n_levels)) if emit_levels is None
            else tuple(emit_levels))
    dtype = data_levels[0].dtype
    pkey = ("counts", len(names), bc, str(dtype), emit)
    fns = getattr(dstate, "_mc_enum_fns", None)
    if fns is None:
        fns = dstate._mc_enum_fns = {}
    if pkey not in fns:
        fns[pkey] = _enum_fn_shared(
            dstate, pkey,
            lambda: _build_enum_fn(meta, dstate.lmeta, consts, bc, nf,
                                   3, None, None, None, unwraps,
                                   spans_all, emit, counts_only=True))
    dev = fns[pkey](data_levels, masks, inlev_devs, ok_devs, iso_val)
    return np.asarray(dev) if fetch else dev


def extract_isosurface_enum(dstate: DenseAmrState, iso_name: str,
                            iso_val: float,
                            extra_names: Sequence[str] = (),
                            bc=None, label: Optional[str] = None,
                            emit_levels=None, want_eids: bool = False,
                            defer: bool = False, decode_lmeta=None):
    """Sort-free single-dispatch single-fetch extraction (enum engine).
    With want_eids, returns (MEF, node_lev [n], node_eid [n],
    tri_lev_counts) for the sparse per-cluster merge.  With defer=True the
    packed result stays on device (only the count header is fetched) and a
    :class:`DeferredSurface` is returned — the pipeline-mode path where a
    downstream stage consumes seeds without the full surface payload.
    decode_lmeta overrides the lmeta used for the HOST-side eid decode:
    a canonical-frame cluster run passes its GLOBAL window lmeta (equal
    shapes, translated los) so merge keys come out in global coordinates
    (amr/canonical.py)."""
    if defer and want_eids:
        raise ValueError("defer is not supported with want_eids (the "
                         "sparse merge needs the decoded edge ids)")
    meta = dstate.meta
    names = [iso_name] + [n for n in extra_names if n != iso_name]
    if bc is None:
        bc = default_bc(3)
    nf = 3 + len(names)

    (data_levels, masks, ok_devs, inlev_devs, consts, unwraps,
     spans_all) = _enum_prep(dstate, names, bc)
    dtype = data_levels[0].dtype
    words = 2 if dtype == jnp.float64 else 1

    caps_d = getattr(dstate, "_mc_enum_caps", None)
    if caps_d is None:
        caps_d = dstate._mc_enum_caps = {}
    ncaps_d = getattr(dstate, "_mc_enum_ncaps", None)
    if ncaps_d is None:
        ncaps_d = dstate._mc_enum_ncaps = {}
    tri_cap = getattr(dstate, "_mc_enum_tricap", 1 << 15)
    fns = getattr(dstate, "_mc_enum_fns", None)
    if fns is None:
        fns = dstate._mc_enum_fns = {}

    nl = meta.n_levels
    emit = tuple(range(nl)) if emit_levels is None else tuple(emit_levels)
    ne = len(emit)
    # cap padding granularity: smaller gran = smaller packed fetch, bigger
    # gran = fewer
    # recompiles across surfaces; 2048 rows is ~24 KB of payload per step
    gran = 2048
    tot_cells = sum(int(np.prod(dstate.lmeta[lev].bbox.shape))
                    for lev in range(nl))
    if (not caps_d or not ncaps_d) and tot_cells > _PROBE_MIN_CELLS:
        # first extraction on a LARGE state: probe the exact counts with a
        # small (fast-compiling) graph, so the big engine compiles ONCE
        # with the right caps instead of 2-4 full builds through the
        # adaptation loop.  Small
        # states skip the probe: their full build is cheap enough that the
        # extra probe graph isn't worth it.
        pkey = ("counts", len(names), bc, str(dtype), emit)
        if pkey not in fns:
            fns[pkey] = _enum_fn_shared(
                dstate, pkey,
                lambda: _build_enum_fn(meta, dstate.lmeta, consts, bc, nf,
                                       3, None, None, None, unwraps,
                                       spans_all, emit, counts_only=True))
        pc = np.asarray(fns[pkey](data_levels, masks, inlev_devs, ok_devs,
                                  iso_val))
        for k, lev in enumerate(emit):
            caps_d[lev] = _pad_gran(max(int(pc[k]), 1), gran, gran)
        for lev in range(nl):
            ncaps_d[lev] = _pad_gran(max(int(pc[ne + lev]), 1), gran, gran)
        tri_cap = dstate._mc_enum_tricap = _pad_gran(
            max(int(pc[ne + nl]), 1), gran, gran)
        if sum(int(pc[ne + lev]) for lev in range(nl)) >= (1 << 21):
            dstate._mc_enum_wide = True    # id packing won't fit: go wide

    wide = bool(getattr(dstate, "_mc_enum_wide", False))
    for _attempt in range(5):
        caps = tuple(caps_d.get(lev, 1 << 14) for lev in range(nl))
        node_caps = tuple(ncaps_d.get(lev, 1 << 14) for lev in range(nl))
        key = (len(names), bc, caps, node_caps, tri_cap, str(dtype),
               emit, want_eids, wide)
        if key not in fns:
            fns[key] = _enum_fn_shared(
                dstate, key,
                lambda: _build_enum_fn(meta, dstate.lmeta, consts, bc, nf,
                                       3, caps, node_caps, tri_cap, unwraps,
                                       spans_all, emit, want_eids,
                                       wide_tris=wide))
        packed_dev = fns[key](data_levels, masks, inlev_devs,
                              ok_devs, iso_val)
        if defer:
            # one small fetch: count header + bitcast xyz columns; the
            # full payload stays on device
            hx = np.asarray(_head_xyz(packed_dev, node_caps, tri_cap, ne,
                                      nl, want_eids, words, nf - 1,
                                      3 if wide else 2))
            head = hx[: 2 + ne + nl + ne]
            xyz_rows = hx[2 + ne + nl + ne:].view(
                np.float64 if words == 2 else np.float32).reshape(-1, 3)
            packed = None
        else:
            packed = np.asarray(packed_dev)
            head = packed
        n_uniq, n_tri = int(head[0]), int(head[1])
        n_act = [int(v) for v in head[2: 2 + ne]]
        n_nod = [int(v) for v in head[2 + ne: 2 + ne + nl]]
        tri_ns = [int(v) for v in head[2 + ne + nl: 2 + ne + nl + ne]]
        ok = True
        for k, lev in enumerate(emit):
            if n_act[k] > caps[lev]:
                ok = False
            caps_d[lev] = _pad_gran(max(n_act[k], 1), gran, gran)
        for lev in range(nl):
            if n_nod[lev] > node_caps[lev]:
                ok = False
            ncaps_d[lev] = _pad_gran(max(n_nod[lev], 1), gran, gran)
        if n_tri > tri_cap:
            tri_cap = dstate._mc_enum_tricap = _pad_gran(n_tri, gran, gran)
            ok = False
        if n_uniq >= (1 << 21) and not wide:
            # id packing tops out at 2^21 nodes: re-dispatch with
            # full-width (3×int32) element ids — no node-count ceiling
            wide = dstate._mc_enum_wide = True
            ok = False
        if ok:
            break
    decode_kw = dict(nl=nl, ne=ne, node_caps=node_caps,
                     tri_cap=tri_cap, want_eids=want_eids, words=words,
                     nf=nf, names=names, iso_val=iso_val, label=label,
                     lmeta=decode_lmeta or dstate.lmeta, n_nod=n_nod,
                     n_tri=n_tri, wide_tris=wide)
    if defer:
        surf = DeferredSurface(packed_dev, decode_kw,
                               (n_uniq, n_tri), xyz_rows=xyz_rows)
        if want_eids:
            return surf, None, None, tri_ns
        return surf
    mef, node_lev, node_eid = _decode_packed(packed, **decode_kw)
    if want_eids:
        return mef, node_lev, node_eid, tri_ns
    return mef


def _classify_numpy(field: np.ndarray, iso_val: float) -> np.ndarray:
    inside = (field < iso_val).astype(np.int32)
    ci = 0
    for b, (oi, oj, ok) in enumerate(np.asarray(CORNER_OFFSETS)):
        view = inside[oi: inside.shape[0] - 1 + oi,
                      oj: inside.shape[1] - 1 + oj,
                      ok: inside.shape[2] - 1 + ok]
        ci = ci + view * (1 << b)
    return ci


def _emit_device(dstate, lev, grown, inlev_p, ai, aj, ak, cia, iso_val,
                 nf):
    """Device-path emission for active cells: host computes keys + triangle
    topology; vertex data is interpolated on device and STAYS there (the
    assembly step gathers only the deduplicated rows)."""
    ck = np.empty((8, len(ai)), dtype=np.int64)
    for b, o in enumerate(np.asarray(CORNER_OFFSETS)):
        ck[b] = _corner_keys_at(dstate, lev, inlev_p,
                                ai + o[0], aj + o[1], ak + o[2])
    ekeys = np.empty((len(ai), 12, 2), dtype=np.int64)
    for e, (a, b) in enumerate(np.asarray(CORNER_PAIRS)):
        ka, kb = ck[a], ck[b]
        ekeys[:, e, 0] = np.minimum(ka, kb)
        ekeys[:, e, 1] = np.maximum(ka, kb)

    # interpolate only the edges the case table references (edgeTable bits)
    used = EDGE_TABLE[cia]
    cell_of, edge_of = [], []
    for e in range(12):
        sel = np.nonzero(used & (1 << e))[0]
        cell_of.append(sel)
        edge_of.append(np.full(len(sel), e, dtype=np.int32))
    cell_of = np.concatenate(cell_of)
    edge_of = np.concatenate(edge_of)
    row_of = np.full((len(ai), 12), -1, dtype=np.int64)
    row_of[cell_of, edge_of] = np.arange(len(cell_of))
    nu = len(cell_of)
    npad = _pad_pow2(nu)
    padz = np.zeros(npad - nu, dtype=np.int32)
    args = [jnp.asarray(np.concatenate([x[cell_of].astype(np.int32), padz]))
            for x in (ai, aj, ak)]
    eidj = jnp.asarray(np.concatenate([edge_of, padz]))
    used_evals = _gather_used_edge_verts(grown, *args, eidj, iso_val)

    tt = TRI_TABLE[cia]
    cnt = TRI_COUNT[cia]
    max_t = int(cnt.max())
    tri_e = tt[:, : 3 * max_t].reshape(len(ai), max_t, 3)
    valid = (np.arange(max_t)[None, :] < cnt[:, None])
    ci_idx, ti_idx = np.nonzero(valid)
    edges = tri_e[ci_idx, ti_idx]
    tri_keys = ekeys[ci_idx[:, None], edges]
    rows = row_of[ci_idx[:, None], edges]
    return tri_keys, (rows, used_evals)


def extract_level(dstate: DenseAmrState, lev: int, iso_comp: int,
                  iso_val: float, grown: np.ndarray,
                  cov: np.ndarray, inlev_p: np.ndarray,
                  classify: str = "device", ci: np.ndarray = None,
                  active=None):
    """Triangles of one level: returns (edge_keys [Nt,3,2], vdata [Nt,3,nf])."""
    meta = dstate.meta
    geom = meta.geoms[lev]
    dom = geom.domain
    gbox = dstate.lmeta[lev].bbox.grow(1)
    nf = grown.shape[0]

    device = classify == "device" and isinstance(grown, jnp.ndarray)
    if device:
        if active is not None:
            shp = tuple(s - 1 for s in cov.shape)
            flat, cia = active
            if len(flat) == 0:
                return (np.zeros((0, 3, 2), np.int64),
                        (np.zeros((0, 3), np.int64), None))
            ai, aj, ak = np.unravel_index(flat, shp)
            return _emit_device(dstate, lev, grown, inlev_p, ai, aj, ak,
                                cia.astype(np.int32), iso_val, nf)
        if ci is None:
            ci = np.asarray(_classify(grown[iso_comp], iso_val)
                            .astype(jnp.uint8))
        field = None
    else:
        grown = np.asarray(grown)
        field = grown[iso_comp]
        if classify == "numpy":
            ci = _classify_numpy(field, iso_val)
        else:
            ci = np.asarray(_classify(jnp.asarray(field), iso_val))

    # corner windows over base cells
    def win(a, o):
        return a[o[0]: a.shape[-3] - 1 + o[0],
                 o[1]: a.shape[-2] - 1 + o[1],
                 o[2]: a.shape[-1] - 1 + o[2]]

    ok = np.ones(ci.shape, dtype=bool)
    touch = np.zeros(ci.shape, dtype=bool)
    for o in np.asarray(CORNER_OFFSETS):
        ok &= ~win(cov, o)
        touch |= win(inlev_p, o)
    # corners must stay inside the (periodically grown) domain
    for d in range(3):
        base = np.arange(gbox.lo[d], gbox.hi[d])  # base-cell coords, len S-1
        lo_ok = base >= (dom.lo[d] - 1 if geom.is_periodic[d] else dom.lo[d])
        hi_ok = base + 1 <= (dom.hi[d] + 1 if geom.is_periodic[d]
                             else dom.hi[d])
        sh = [1, 1, 1]
        sh[d] = -1
        ok &= (lo_ok & hi_ok).reshape(sh)
    active = ok & touch & (EDGE_TABLE[ci] != 0)
    ai, aj, ak = np.nonzero(active)
    if len(ai) == 0:
        if classify == "device" and isinstance(grown, jnp.ndarray):
            return (np.zeros((0, 3, 2), np.int64),
                    (np.zeros((0, 3), np.int64), None))
        return (np.zeros((0, 3, 2), np.int64), np.zeros((0, 3, nf)))
    cia = ci[ai, aj, ak]                                   # [Na]
    if device:
        return _emit_device(dstate, lev, grown, inlev_p, ai, aj, ak,
                            cia, iso_val, nf)

    # corner keys (host) computed only for active cells
    ck = np.empty((8, len(ai)), dtype=np.int64)
    for b, o in enumerate(np.asarray(CORNER_OFFSETS)):
        ck[b] = _corner_keys_at(dstate, lev, inlev_p,
                                ai + o[0], aj + o[1], ak + o[2])
    ekeys = np.empty((len(ai), 12, 2), dtype=np.int64)
    for e, (a, b) in enumerate(np.asarray(CORNER_PAIRS)):
        ka, kb = ck[a], ck[b]
        ekeys[:, e, 0] = np.minimum(ka, kb)
        ekeys[:, e, 1] = np.maximum(ka, kb)

    cf = np.empty((8, len(ai)))
    cd = np.empty((8, len(ai), nf))
    for b, o in enumerate(np.asarray(CORNER_OFFSETS)):
        ii, jj, kk = ai + o[0], aj + o[1], ak + o[2]
        cf[b] = field[ii, jj, kk]
        cd[b] = np.moveaxis(grown[:, ii, jj, kk], 0, -1)
    evals = np.empty((len(ai), 12, nf))
    for e, (a, b) in enumerate(np.asarray(CORNER_PAIRS)):
        fa, fb = cf[a], cf[b]
        denom = fb - fa
        t = np.where(np.abs(denom) > 1e-300, (iso_val - fa)
                     / np.where(denom == 0, 1.0, denom), 0.0)
        t = np.clip(t, 0.0, 1.0)
        evals[:, e, :] = cd[a] + t[:, None] * (cd[b] - cd[a])

    # triangles from the table
    tt = TRI_TABLE[cia]                                     # [Na,16]
    cnt = TRI_COUNT[cia]                                    # [Na]
    max_t = int(cnt.max())
    tri_e = tt[:, : 3 * max_t].reshape(len(ai), max_t, 3)   # edge ids or -1
    valid = (np.arange(max_t)[None, :] < cnt[:, None])      # [Na,max_t]
    ci_idx, ti_idx = np.nonzero(valid)
    edges = tri_e[ci_idx, ti_idx]                           # [Nt,3]
    tri_keys = ekeys[ci_idx[:, None], edges]                # [Nt,3,2]
    tri_vals = evals[ci_idx[:, None], edges]                # [Nt,3,nf]
    return tri_keys, tri_vals


def _fused_consts(dstate):
    """Static per-level integer tuples + coordinate-unwrap slices for the
    fused extractor (cached: they only depend on the hierarchy)."""
    cached = getattr(dstate, "_mc_fused_consts", None)
    if cached is not None:
        return cached
    meta = dstate.meta
    consts, unwraps = [], []
    for lev in range(meta.n_levels):
        geom = meta.geoms[lev]
        dom = geom.domain
        gbox = dstate.lmeta[lev].bbox.grow(1)
        r = meta.ref_ratio[lev - 1] if lev > 0 else 1
        domc = dom.coarsen(r) if lev > 0 else dom
        consts.append((lev, tuple(gbox.lo), tuple(dom.lo), tuple(dom.shape),
                       tuple(bool(p) for p in geom.is_periodic), int(r),
                       tuple(domc.lo)))
        uw = []
        for d in range(3):
            if not geom.is_periodic[d]:
                continue
            L = float(geom.prob_hi[d] - geom.prob_lo[d])
            if gbox.lo[d] < dom.lo[d]:
                sl = [slice(None)] * 3
                sl[d] = slice(0, dom.lo[d] - gbox.lo[d])
                uw.append(((d,) + tuple(sl), -L))
            if gbox.hi[d] > dom.hi[d]:
                # every slot beyond the domain hi is a periodic image
                # (bucket/mesh pads included), not just the last ghost
                sl = [slice(None)] * 3
                sl[d] = slice(dom.hi[d] + 1 - gbox.lo[d], gbox.shape[d])
                uw.append(((d,) + tuple(sl), L))
        unwraps.append(tuple(uw))
    dstate._mc_fused_consts = (tuple(consts), tuple(unwraps))
    return dstate._mc_fused_consts


def extract_isosurface_fused(dstate: DenseAmrState, iso_name: str,
                             iso_val: float,
                             extra_names: Sequence[str] = (),
                             bc=None, label: Optional[str] = None) -> MEF:
    """Single-dispatch single-fetch extraction (see the fused block above).
    Produces the same MEF as extract_isosurface up to node/element order."""
    meta = dstate.meta
    names = [iso_name] + [n for n in extra_names if n != iso_name]
    comps = [dstate.comp(n) for n in names]
    if bc is None:
        bc = default_bc(3)
    nf = 3 + len(names)

    data_levels = _data_levels_cached(dstate, comps)
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]
    ok_devs = [_ok_mask_dev(dstate, lev)[0] for lev in range(meta.n_levels)]
    inlev_devs = getattr(dstate, "_mc_inlev_dev", None)
    if inlev_devs is None:
        inlev_devs = dstate._mc_inlev_dev = [
            jnp.asarray(_grown_masks(dstate, lev)[1])
            for lev in range(meta.n_levels)]
    consts, unwraps = _fused_consts(dstate)
    dtype = data_levels[0].dtype
    words = 2 if dtype == jnp.float64 else 1

    caps_d = getattr(dstate, "_mc_caps", None)
    if caps_d is None:
        caps_d = dstate._mc_caps = {}
    node_cap = getattr(dstate, "_mc_node_cap", 1 << 15)
    tri_cap = getattr(dstate, "_mc_tri_cap", 1 << 15)
    fns = getattr(dstate, "_mc_fused_fns", None)
    if fns is None:
        fns = dstate._mc_fused_fns = {}

    for _attempt in range(4):
        caps = tuple(caps_d.get(lev, 1 << 14)
                     for lev in range(meta.n_levels))
        key = (len(names), bc, caps, node_cap, tri_cap, str(dtype))
        if key not in fns:
            fns[key] = _build_fused_fn(meta, dstate.lmeta, consts, bc, nf,
                                       3, caps, node_cap, tri_cap, unwraps)
        packed = np.asarray(fns[key](data_levels, masks, inlev_devs,
                                     ok_devs, iso_val))
        nl = meta.n_levels
        n_uniq, n_tri = int(packed[0]), int(packed[1])
        n_act = [int(v) for v in packed[2: 2 + nl]]
        ok = True
        for lev in range(nl):
            if n_act[lev] > caps[lev]:
                caps_d[lev] = _pad_pow2(n_act[lev])
                ok = False
            else:
                caps_d[lev] = max(_pad_pow2(max(n_act[lev], 1)), 1 << 12)
        if n_uniq > node_cap:
            node_cap = dstate._mc_node_cap = _pad_pow2(n_uniq)
            ok = False
        if n_tri > tri_cap:
            tri_cap = dstate._mc_tri_cap = _pad_pow2(n_tri)
            ok = False
        if ok:
            break
    base = 2 + nl
    elements = packed[base: base + tri_cap * 3].reshape(tri_cap, 3)[:n_tri]
    nbits = packed[base + tri_cap * 3:]
    nodes = nbits.view(np.float64 if words == 2
                       else np.float32).reshape(node_cap, nf)[:n_uniq]
    if n_uniq == 0:
        return MEF(label or "0", ["X", "Y", "Z"] + names,
                   np.zeros((0, nf)), np.zeros((0, 3), np.int32))
    return MEF(label or "0", ["X", "Y", "Z"] + names,
               np.asarray(nodes, np.float64),
               np.asarray(elements, np.int32))


def _cluster_substates(state, waste_factor: float = 4.0):
    """Split the finest level's BoxArray into dense clusters; returns a list
    of DenseAmrStates sharing the coarse dense arrays (zero copies) with the
    finest level assembled per cluster (memory ~ cluster bbox, not union
    bbox).  Coarse-level covered masks are the GLOBAL ones so every run sees
    the same coarse activity."""
    import dataclasses as _dc

    from ..amr.cluster import cluster_boxes
    from ..amr.dense import (DenseAmrState, DenseLevelMeta, _assemble_dense,
                             _union_mask_np)
    from ..amr.hierarchy import AmrMeta

    meta = state.meta
    fin = meta.n_levels - 1
    groups = cluster_boxes(meta.bas[fin], waste_factor)
    base = DenseAmrState.from_batched_coarse_only(state)
    subs = []
    for g in groups:
        ba_g = BoxArray([list(meta.bas[fin])[i] for i in g])
        meta_g = AmrMeta(meta.geoms, meta.bas[:fin] + [ba_g],
                         meta.ref_ratio, meta.time, meta.level_steps,
                         meta.ndim2)
        bbox_g = ba_g.minimal_box()
        lmeta_g = base.lmeta[:fin] + [DenseLevelMeta(
            bbox_g, meta.geoms[fin], ba_g.total_cells() / bbox_g.size)]
        data_g = list(base.data[:fin]) + [_assemble_dense(
            state.data[fin][np.asarray(g)], ba_g, bbox_g)]
        sub = DenseAmrState(meta_g, state.names, data_g, lmeta_g)
        # share coarse masks + the GLOBAL covered masks (computed from the
        # full fine BoxArray on the base state) — a sub-run must see the
        # same coarse activity as the global extraction or it would emit
        # coarse triangles under OTHER clusters' fine regions
        sub._mc_masks = {}
        sub._mc_okdev = {}
        for lev in range(fin):
            sub._in_level[lev] = base.in_level_mask(lev)
            sub._covered[lev] = base.covered_mask(lev)
            sub._mc_masks[lev] = _grown_masks(base, lev)
            sub._mc_okdev[lev] = _ok_mask_dev(base, lev)
        subs.append(sub)
    return subs, base


def _window_coords(meta, windows, dtype):
    """TRUE physical cell-center coordinate fields for canonical-frame
    windows (the canonical geoms carry prob_lo=0; positions enter the
    engine as traced data, so node xyz come out globally correct with no
    per-cluster constants in the graph)."""
    out = []
    for lev, wb in enumerate(windows):
        geom = meta.geoms[lev]
        cs = [geom.prob_lo[d]
              + (np.arange(wb.lo[d], wb.hi[d] + 1)
                 - geom.domain.lo[d] + 0.5) * geom.dx[d] for d in range(3)]
        X, Y, Z = np.meshgrid(*cs, indexing="ij")
        out.append(jnp.asarray(np.stack([X, Y, Z]), dtype))
    return out


def _extract_enum_batched(subs, decode_lmetas, iso_name, iso_val,
                          extra_names, bc, label, emit, ndevices):
    """Cluster-axis SPMD enum extraction: K equal-bucket canonical clusters
    stack on a leading batch axis, the enum engine is ``jax.vmap``-ed over
    it, and the batch shards over a 1-D cluster mesh
    (parallel/cluster_shard.py rationale) — ONE dispatch and ONE packed
    fetch replace K of each, and with ndevices>1 each device owns
    ceil(K/n) clusters.
    Returns the same (mef, node_lev, node_eid, tri_ns) tuples the serial
    ``extract_isosurface_enum(want_eids=True)`` yields, one per sub."""
    import jax

    from ..parallel.cluster_shard import CLUSTER_AXIS, cluster_mesh

    tpl = subs[0]
    meta = tpl.meta
    names = [iso_name] + [n for n in extra_names if n != iso_name]
    if bc is None:
        bc = default_bc(3)
    nf = 3 + len(names)
    nl = meta.n_levels
    ne = len(emit)
    preps = [_enum_prep(s, names, bc) for s in subs]
    consts, unwraps, spans_all = preps[0][4], preps[0][5], preps[0][6]
    dtype = preps[0][0][0].dtype
    words = 2 if dtype == jnp.float64 else 1
    gran = 2048

    K = len(subs)
    # the mesh size is what matters for divisibility: cluster_mesh truncates
    # to the AVAILABLE devices, so a request larger than the host must pad
    # to the actual mesh size, not the request
    mesh = cluster_mesh(ndevices) if ndevices > 1 else None
    ndev = int(mesh.devices.size) if mesh is not None else 1
    Kp = ((K + ndev - 1) // ndev) * ndev
    reps = [j % K for j in range(Kp)]   # pad rows repeat clusters (inert)

    def stack(idx):
        return [jnp.stack([preps[j][idx][lev] for j in reps])
                for lev in range(nl)]

    datas, masks_s, oks, inls = stack(0), stack(1), stack(2), stack(3)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(mesh, P(CLUSTER_AXIS))
        put = lambda ls: [jax.device_put(a, sh) for a in ls]
        datas, masks_s, oks, inls = (put(datas), put(masks_s), put(oks),
                                     put(inls))

    caps_d = getattr(tpl, "_mc_enum_caps", None)
    if caps_d is None:
        caps_d = tpl._mc_enum_caps = {}
    ncaps_d = getattr(tpl, "_mc_enum_ncaps", None)
    if ncaps_d is None:
        ncaps_d = tpl._mc_enum_ncaps = {}
    tri_cap = getattr(tpl, "_mc_enum_tricap", 1 << 15)
    wide = bool(getattr(tpl, "_mc_enum_wide", False))

    for _attempt in range(5):
        caps = tuple(caps_d.get(lev, 1 << 14) for lev in range(nl))
        node_caps = tuple(ncaps_d.get(lev, 1 << 14) for lev in range(nl))
        key = ("batched", Kp, ndev, len(names), bc, caps, node_caps,
               tri_cap, str(dtype), emit, wide)
        fn = _enum_fn_shared(
            tpl, key,
            lambda: jax.jit(jax.vmap(
                _build_enum_fn(meta, tpl.lmeta, consts, bc, nf, 3, caps,
                               node_caps, tri_cap, unwraps, spans_all,
                               emit, want_eids=True, wide_tris=wide),
                in_axes=(0, 0, 0, 0, None))))
        all_packed = np.asarray(fn(datas, masks_s, inls, oks, iso_val))
        ok = True
        for k in range(K):
            head = all_packed[k]
            if int(head[0]) >= (1 << 21) and not wide:
                wide = tpl._mc_enum_wide = True
                ok = False
            n_act = [int(v) for v in head[2: 2 + ne]]
            n_nod = [int(v) for v in head[2 + ne: 2 + ne + nl]]
            for j, lev in enumerate(emit):
                if n_act[j] > caps[lev]:
                    ok = False
                caps_d[lev] = max(caps_d.get(lev, 0),
                                  _pad_gran(max(n_act[j], 1), gran, gran))
            for lev in range(nl):
                if n_nod[lev] > node_caps[lev]:
                    ok = False
                ncaps_d[lev] = max(ncaps_d.get(lev, 0),
                                   _pad_gran(max(n_nod[lev], 1), gran, gran))
            if int(head[1]) > tri_cap:
                tri_cap = _pad_gran(int(head[1]), gran, gran)
                ok = False
        tpl._mc_enum_tricap = tri_cap
        if ok:
            break

    results = []
    for k in range(K):
        head = all_packed[k]
        n_uniq, n_tri = int(head[0]), int(head[1])
        n_nod = [int(v) for v in head[2 + ne: 2 + ne + nl]]
        tri_ns = [int(v) for v in head[2 + ne + nl: 2 + ne + nl + ne]]
        mef, node_lev, node_eid = _decode_packed(
            all_packed[k], nl=nl, ne=ne, node_caps=node_caps,
            tri_cap=tri_cap, want_eids=True, words=words, nf=nf,
            names=names, iso_val=iso_val, label=label,
            lmeta=decode_lmetas[k], n_nod=n_nod, n_tri=n_tri,
            wide_tris=wide)
        results.append((mef, node_lev, node_eid, tri_ns))
    return results


def extract_isosurface_sparse(state, iso_name: str, iso_val: float,
                              extra_names: Sequence[str] = (),
                              bc=None, label: Optional[str] = None,
                              waste_factor: float = 4.0,
                              ndevices: int = 1,
                              cluster_batch: Optional[bool] = None) -> MEF:
    """Sparse-refinement extraction: the finest level is processed as dense
    CLUSTERS so HBM scales with valid cells instead of the union bounding
    box (the reference gets this for free from per-rank box ownership;
    isosurface.cpp:1531 MFIter).  One GLOBAL COARSE pass emits levels
    0..fin-1 (fine-covered cells excluded via the full hierarchy's covered
    mask); each cluster run emits only its fine triangles in a CANONICAL
    translated frame (amr/canonical.py), so every equal-bucket cluster
    shares ONE compiled engine instead of one compile per cluster.  Node
    identity is the canonical
    (level, edge-id) pair in GLOBAL coordinates (decode_lmeta), so the
    cross-run merge stays EXACT integer dedup."""
    from ..amr.canonical import (canonical_cluster_substates,
                                 coarse_only_state, _crop_np)
    from ..amr.dense import DenseLevelMeta

    meta = state.meta
    fin = meta.n_levels - 1
    groups, subs, base, infos = canonical_cluster_substates(
        state, ngrow_max=1, interp_stencil=0, waste_factor=waste_factor)
    dtype = state.data[0].dtype

    for sub, info in zip(subs, infos):
        if getattr(sub, "_mc_masks", None):
            continue       # cached canonical substate: masks/coords persist
        sub._mc_masks = {}
        sub._mc_okdev = {}
        if info.canonical:
            for lev in range(fin):
                cov_b, inl_b = _grown_masks(base, lev)
                gb = base.lmeta[lev].bbox.grow(1)
                wb = info.windows[lev].grow(1)
                sub._mc_masks[lev] = (_crop_np(cov_b, gb, wb),
                                      _crop_np(inl_b, gb, wb))
            sub._mc_coords = _window_coords(meta, info.windows, dtype)
        else:
            # round-3 exact fallback (boundary clusters): global coarse
            # arrays, global masks
            for lev in range(fin):
                sub._mc_masks[lev] = _grown_masks(base, lev)
                sub._mc_okdev[lev] = _ok_mask_dev(base, lev)

    # ---- pin caps across canonical runs: probe with ONE shared small
    # engine, set every cluster's caps to the maxima so the big engine
    # compiles ONCE (per-run shrink-refits stay private per instance) ------
    can_idx = [i for i, inf in enumerate(infos) if inf.canonical]
    nl = fin + 1
    if len(can_idx) > 1:
        # dispatch every cluster's probe, reduce on DEVICE, fetch once —
        # instead of a serial np.asarray (one fetch) per cluster
        pcs = [enum_probe_counts(subs[i], iso_name, iso_val, extra_names,
                                 bc, (fin,), fetch=False)
               for i in can_idx]
        mx = np.asarray(_probe_max(pcs))
        gran = 2048
        for i in can_idx:
            subs[i]._mc_enum_caps = {fin: _pad_gran(int(mx[0]), gran, gran)}
            subs[i]._mc_enum_ncaps = {
                lev: _pad_gran(int(mx[1 + lev]), gran, gran)
                for lev in range(nl)}
            subs[i]._mc_enum_tricap = _pad_gran(int(mx[1 + nl]), gran, gran)

    # cluster-axis SPMD (parallel/cluster_shard.py rationale): canonical
    # clusters batch into ONE vmapped dispatch + ONE packed fetch per
    # bucket, sharded over the mesh when ndevices>1 (default on there;
    # cluster_batch=1 opts in single-device batching)
    batch = (ndevices > 1) if cluster_batch is None else bool(cluster_batch)
    batched_res = {}
    if batch and fin > 0 and can_idx:
        from ..amr.dense import hier_fingerprint
        buckets = {}
        for i in can_idx:
            buckets.setdefault(hier_fingerprint(subs[i]), []).append(i)
        for idx in buckets.values():
            dls = [[DenseLevelMeta(infos[i].windows[lev], meta.geoms[lev],
                                   1.0) for lev in range(nl)] for i in idx]
            rr = _extract_enum_batched(
                [subs[i] for i in idx], dls, iso_name, iso_val,
                extra_names, bc, label, (fin,), ndevices)
            for i, r in zip(idx, rr):
                batched_res[i] = r

    def run_cluster(k):
        if k in batched_res:
            return batched_res[k]
        dl = None
        if infos[k].canonical:
            dl = [DenseLevelMeta(infos[k].windows[lev], meta.geoms[lev], 1.0)
                  for lev in range(nl)]
        return extract_isosurface_enum(
            subs[k], iso_name, iso_val, extra_names, bc, label,
            emit_levels=(fin,), want_eids=True, decode_lmeta=dl)

    results = []
    if fin > 0:
        cds = coarse_only_state(state, base)
        cds._mc_masks = {}
        cds._mc_okdev = {}
        for lev in range(fin):
            # masks from the FULL hierarchy: fine-covered coarse cells must
            # not emit (the coarse meta alone cannot know them)
            cds._mc_masks[lev] = _grown_masks(base, lev)
            cds._mc_okdev[lev] = _ok_mask_dev(base, lev)
        results.append(extract_isosurface_enum(
            cds, iso_name, iso_val, extra_names, bc, label,
            want_eids=True))
    # legacy (boundary) engines still compile CONCURRENTLY; canonical runs
    # hit the shared engine after the first
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(len(subs), 8)) as ex:
        results += list(ex.map(run_cluster, range(len(subs))))

    all_nodes, all_eid, all_tris = [], [], []
    names = None
    for k, (mef, nlev, neid, _) in enumerate(results):
        names = mef.names
        all_nodes.append(mef.nodes)
        all_eid.append(neid)        # global (lev, axis, cell) packed keys
        all_tris.append((k, mef.elements))
    # exact merge: unique (lev, eid) keys; remap each run's elements
    cat_keys = np.concatenate(all_eid)
    uniq, inv = np.unique(cat_keys, return_inverse=True)
    nodes = np.zeros((len(uniq), all_nodes[0].shape[1]))
    off = 0
    elements = []
    for (k, el), nd, kid in zip(all_tris, all_nodes, all_eid):
        gid = inv[off: off + len(kid)]
        nodes[gid] = nd
        elements.append(gid[el])
        off += len(kid)
    elements = (np.concatenate(elements).astype(np.int32)
                if elements else np.zeros((0, 3), np.int32))
    return MEF(label or "0", names or ["X", "Y", "Z", iso_name],
               nodes, elements)


def extract_isosurface(
    dstate: DenseAmrState,
    iso_name: str,
    iso_val: float,
    extra_names: Sequence[str] = (),
    bc=None,
    label: Optional[str] = None,
    classify: str = "device",
    defer: bool = False,
) -> MEF:
    """Marching-cubes isosurface over all levels -> deduplicated MEF.
    defer=True (enum engine only) keeps the surface payload on device and
    returns a DeferredSurface — see extract_isosurface_enum."""
    if classify == "fused":
        return extract_isosurface_fused(dstate, iso_name, iso_val,
                                        extra_names, bc, label)
    if classify == "enum":
        # no node-count ceiling: surfaces past 2^21 nodes automatically
        # re-dispatch with full-width (3x int32) element ids
        return extract_isosurface_enum(dstate, iso_name, iso_val,
                                       extra_names, bc, label,
                                       defer=defer)
    meta = dstate.meta
    names = [iso_name] + [n for n in extra_names if n != iso_name]
    comps = [dstate.comp(n) for n in names]
    if bc is None:
        bc = default_bc(3)

    data_levels = _data_levels_cached(dstate, comps)
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]

    cache = getattr(dstate, "_mc_fill_cache", None)
    if cache is None:
        cache = dstate._mc_fill_cache = {}
    key = (len(names), bc)
    if key not in cache:
        cache[key] = jax.jit(lambda dl, ml: fill_dense_multilevel(
            meta, dstate.lmeta, dl, ml, 1, bc, "pc"))
    grown_all = cache[key](data_levels, masks)
    ci_all = None
    active_all = None
    if classify == "device":
        # classify on device; discover active cells on device; fetch only the
        # (few) active indices + case values — full ci arrays stay in HBM
        ci_dev = _classify_all_levels(grown_all, iso_val)
        ok_devs = [_ok_mask_dev(dstate, lev)[0]
                   for lev in range(meta.n_levels)]
        # speculative capacities (cached from the previous extraction) let us
        # fetch indices + counts in ONE roundtrip; on overflow we refetch
        caps = getattr(dstate, "_mc_caps", None)
        if caps is None:
            caps = dstate._mc_caps = {}
        cap_t = tuple(caps.get(lev, 1 << 15) for lev in range(meta.n_levels))
        packed = np.asarray(_active_all_packed(ci_dev, ok_devs, cap_t))
        counts = packed[: meta.n_levels]
        base = meta.n_levels
        cia_base = meta.n_levels + sum(cap_t)
        active_all = []
        for lev in range(meta.n_levels):
            cap, n = cap_t[lev], int(counts[lev])
            idx = packed[base: base + cap]
            cia = _unpack_cia4(packed[cia_base: cia_base + cap // 4], cap)
            base += cap
            cia_base += cap // 4
            if n > cap:  # speculation failed: refetch this level full-size
                idx, cia, _ = jax.device_get(_active_cells(
                    ci_dev[lev], ok_devs[lev], _pad_gran(n)))
            caps[lev] = _pad_gran(max(n, 1))
            active_all.append((idx[:n].astype(np.int64), cia[:n]))
    all_keys, all_vals = [], []
    for lev in range(meta.n_levels):
        grown = grown_all[lev]
        # periodic unwrap of ghost-ring coordinates (isosurface.cpp:1482-1507)
        geom = meta.geoms[lev]
        gbox = dstate.lmeta[lev].bbox.grow(1)
        for d in range(3):
            if not geom.is_periodic[d]:
                continue
            L = geom.prob_hi[d] - geom.prob_lo[d]
            if gbox.lo[d] < geom.domain.lo[d]:
                sl = [slice(None)] * 3
                sl[d] = slice(0, 1)
                grown = grown.at[(d,) + tuple(sl)].add(-L)
            if gbox.hi[d] > geom.domain.hi[d]:
                sl = [slice(None)] * 3
                sl[d] = slice(grown.shape[1 + d] - 1, grown.shape[1 + d])
                grown = grown.at[(d,) + tuple(sl)].add(L)
        if classify != "device":
            # host engines: cache the fetched grown arrays on the state (the
            # fill is iso-value independent; refetching 100s of MB per iso
            # value would dominate the host path)
            npc = getattr(dstate, "_mc_np_grown", None)
            if npc is None:
                npc = dstate._mc_np_grown = {}
            gk = (lev, tuple(names), bc)
            if gk not in npc:
                npc[gk] = np.asarray(grown, dtype=np.float64)
            grown = npc[gk]
        cov, inlev_p = _grown_masks(dstate, lev)
        tk, tv = extract_level(dstate, lev, 3, iso_val, grown, cov,
                               inlev_p, classify=classify,
                               active=None if active_all is None
                               else active_all[lev])
        all_keys.append(tk)
        all_vals.append(tv)

    tri_keys = np.concatenate(all_keys)      # [Nt,3,2]
    nf = 3 + len(names)
    if len(tri_keys) == 0:
        return MEF(label or "0", ["X", "Y", "Z"] + names,
                   np.zeros((0, nf)), np.zeros((0, 3), np.int32))

    flat_keys = tri_keys.reshape(-1, 2)
    # lexsort-based row dedup (np.unique(axis=0) goes through a slow
    # void-dtype sort); `first` = first occurrence per unique key
    order = np.lexsort((flat_keys[:, 1], flat_keys[:, 0]))
    sk = flat_keys[order]
    new = np.empty(len(sk), dtype=bool)
    new[0] = True
    np.any(sk[1:] != sk[:-1], axis=1, out=new[1:])
    gid_sorted = np.cumsum(new) - 1
    inv = np.empty(len(sk), dtype=np.int64)
    inv[order] = gid_sorted
    n_uniq = int(gid_sorted[-1]) + 1
    first = np.full(n_uniq, len(flat_keys), dtype=np.int64)
    np.minimum.at(first, gid_sorted, order)
    uniq = sk[new]
    elements = inv.reshape(-1, 3).astype(np.int32)

    if classify == "device":
        # node data still lives in HBM: translate `first` (flat tri-corner
        # index) to (level, used-edge row), gather per level on device, and
        # fetch ONLY the deduplicated node rows
        lev_sizes = [k.reshape(-1, 2).shape[0] for k in all_keys]
        lev_base = np.cumsum([0] + lev_sizes)
        nodes = np.empty((len(uniq), nf))
        used_list, ridx_list, sel_list, n_list = [], [], [], []
        for lev, (rows, used_dev) in enumerate(all_vals):
            sel = np.nonzero((first >= lev_base[lev])
                             & (first < lev_base[lev + 1]))[0]
            if len(sel) == 0 or used_dev is None:
                continue
            local = first[sel] - lev_base[lev]
            rsel = rows.reshape(-1)[local]           # used-edge rows
            npad = _pad_gran(len(rsel), 4096, 256)
            ridx_list.append(jnp.asarray(np.concatenate(
                [rsel.astype(np.int32),
                 np.zeros(npad - len(rsel), np.int32)])))
            used_list.append(used_dev)
            sel_list.append(sel)
            n_list.append(len(rsel))
        if used_list:
            # all levels gathered + concatenated on device: ONE fetch
            got_all = np.asarray(_gather_rows_multi(used_list, ridx_list))
            off = 0
            for sel, n, ridx in zip(sel_list, n_list, ridx_list):
                nodes[sel] = got_all[off: off + n]
                off += len(ridx)
    else:
        tri_vals = np.concatenate(all_vals)
        nodes = tri_vals.reshape(-1, tri_vals.shape[-1])[first]
    return MEF(label or "0", ["X", "Y", "Z"] + names, nodes, elements)


def surface_area(mef: MEF) -> float:
    """computeArea analog (isosurface.cpp:2237-2264)."""
    return mef.total_area()
