"""MEF surface toolbox — the shared implementation behind the
combine/merge/mult/scale/slice/smooth/trim/bin/iso/check MEF tools
(/root/reference/Src/{combineMEF,mergeMEF,multMEF,scaleMEF,sliceMEF,
smoothMEF,trimMEFgen,binMEF,isoMEF,checkIso}.cpp — each of which carries its
own copy of the MEF I/O, the encapsulation TODO in Docs/source/data.rst).

All operations are vectorized numpy over [Nnodes, nvars] node tables and
[Nelts, 3] connectivity; the triangle-clipping core (linear field variation
within each triangle) serves sliceMEF, isoMEF, trimMEFgen, and binMEF alike.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.mef import MEF


# ---------------------------------------------------------------------------
# simple algebra (combineMEF.cpp, mergeMEF.cpp, multMEF.cpp, scaleMEF.cpp)
# ---------------------------------------------------------------------------

def combine_mef(a: MEF, b: MEF, comps_a: Sequence[str],
                comps_b: Sequence[str]) -> MEF:
    """Union of components of two MEFs with identical nodes+connectivity
    (combineMEF.cpp; Docs/source/surfMEFtools.rst)."""
    if a.n_nodes != b.n_nodes or not np.array_equal(a.elements, b.elements):
        raise ValueError("combineMEF: MEFs have different structure")
    names = [n for n in a.names[: a.ndim]]
    cols = [a.positions()]
    for n in comps_a:
        if n not in names:
            names.append(n)
            cols.append(a.field(n)[:, None])
    for n in comps_b:
        if n not in names:
            names.append(n)
            cols.append(b.field(n)[:, None])
    return MEF(a.label, names, np.concatenate(cols, axis=1), a.elements)


def merge_mef(a: MEF, b: MEF) -> MEF:
    """Concatenate two triangle sets, renumbering b's nodes (mergeMEF.cpp)."""
    if a.names != b.names:
        raise ValueError("mergeMEF: component lists differ")
    nodes = np.concatenate([a.nodes, b.nodes])
    elems = np.concatenate([a.elements, b.elements + a.n_nodes])
    return MEF(a.label, a.names, nodes, elems.astype(np.int32))


def mult_mef(a: MEF, b: MEF, comps: Sequence[str]) -> MEF:
    """Pointwise multiply selected comps of a by the same comps of b
    (multMEF.cpp)."""
    out = a.nodes.copy()
    for n in comps:
        out[:, a.names.index(n)] *= b.field(n)
    return MEF(a.label, a.names, out, a.elements)


def scale_mef(a: MEF, comps: Sequence[str],
              factors: Sequence[float]) -> MEF:
    """Scale selected comps by constants (scaleMEF.cpp)."""
    out = a.nodes.copy()
    for n, f in zip(comps, factors):
        out[:, a.names.index(n)] *= f
    return MEF(a.label, a.names, out, a.elements)


# ---------------------------------------------------------------------------
# watertightness (checkIso.cpp:33ff)
# ---------------------------------------------------------------------------

def check_iso(mef: MEF) -> Dict[str, int]:
    """Edge->element incidence counts; watertight closed surfaces have every
    edge shared by exactly 2 elements."""
    e = mef.elements
    nondeg = (e[:, 0] != e[:, 1]) & (e[:, 1] != e[:, 2]) & (e[:, 0] != e[:, 2])
    ed = np.concatenate([e[nondeg][:, [0, 1]], e[nondeg][:, [1, 2]],
                         e[nondeg][:, [2, 0]]])
    ed = np.sort(ed, axis=1)
    _, counts = np.unique(ed, axis=0, return_counts=True)
    return {
        "n_elements": int(mef.n_elts),
        "n_degenerate": int((~nondeg).sum()),
        "n_edges": len(counts),
        "n_boundary_edges": int((counts == 1).sum()),
        "n_nonmanifold_edges": int((counts > 2).sum()),
        "watertight": bool(((counts == 2).all()) if len(counts) else False),
    }


# ---------------------------------------------------------------------------
# triangle clipping in field space (the shared core)
# ---------------------------------------------------------------------------

def _clip_tris_halfspace(tris: np.ndarray, comp: int, val: float,
                         keep_ge: bool) -> np.ndarray:
    """Clip triangles (tris [N,3,nvars]) against field[comp] >= val (or <=).
    Assumes linear variation within each triangle (trimMEFgen's slicing
    assumption, Docs/source/surfMEFtools.rst).  Returns new [M,3,nvars]."""
    f = tris[:, :, comp]
    inside = (f >= val) if keep_ge else (f <= val)
    cnt = inside.sum(axis=1)
    out = [tris[cnt == 3]]

    def lerp(a, b):
        fa, fb = a[:, comp], b[:, comp]
        denom = np.where(np.abs(fb - fa) > 1e-300, fb - fa, 1.0)
        t = np.clip((val - fa) / denom, 0.0, 1.0)[:, None]
        return a + t * (b - a)

    for k in (1, 2):
        sel = np.nonzero(cnt == k)[0]
        if len(sel) == 0:
            continue
        T = tris[sel]
        ins = inside[sel]
        # rotate each triangle so the "lonely" vertex is first
        lone = np.argmax(ins, axis=1) if k == 1 else np.argmin(ins, axis=1)
        idx = (lone[:, None] + np.arange(3)[None]) % 3
        T = np.take_along_axis(T, idx[:, :, None], axis=1)
        A, B, C = T[:, 0], T[:, 1], T[:, 2]
        pab, pac = lerp(A, B), lerp(A, C)
        if k == 1:  # keep vertex A only -> one clipped triangle
            out.append(np.stack([A, pab, pac], axis=1))
        else:  # drop A, keep B and C -> quad (pab, B, C, pac) -> 2 tris
            out.append(np.stack([pab, B, C], axis=1))
            out.append(np.stack([pab, C, pac], axis=1))
    return np.concatenate(out) if out else tris[:0]


def _tri_areas(tris: np.ndarray, ndim: int) -> np.ndarray:
    p = tris[:, :, :ndim]
    if ndim == 3:
        return 0.5 * np.linalg.norm(
            np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=1)
    c = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    return 0.5 * np.abs(c)


def mef_to_tris(mef: MEF) -> np.ndarray:
    return mef.nodes[mef.elements]  # [ne, 3, nvars]


def tris_to_mef(tris: np.ndarray, names, label="trimmed",
                dedup: bool = True) -> MEF:
    flat = tris.reshape(-1, tris.shape[-1])
    if dedup and len(flat):
        # positional dedup on coordinates only (clipped vertices are new)
        uniq, inv = np.unique(np.round(flat, 12), axis=0,
                              return_inverse=True)
        first = np.full(len(uniq), len(flat), dtype=np.int64)
        np.minimum.at(first, inv, np.arange(len(flat)))
        nodes = flat[first]
        elems = inv.reshape(-1, 3).astype(np.int32)
    else:
        nodes = flat
        elems = np.arange(len(flat), dtype=np.int32).reshape(-1, 3)
    return MEF(label, list(names), nodes, elems)


# ---------------------------------------------------------------------------
# trimMEFgen (trimMEFgen.cpp:434-469)
# ---------------------------------------------------------------------------

def trim_mef(mef: MEF, comps: Sequence[str], signs: Sequence[str],
             vals: Sequence[float], rxy: Optional[float] = None,
             sign_rxy: str = "+",
             rem_comps: Sequence[str] = ()) -> MEF:
    tris = mef_to_tris(mef)
    names = list(mef.names)
    if rxy is not None:
        # cylindrical-radius cut RXY (trimMEFgen.cpp:453-456): clip on a
        # temporary radius component
        r = np.sqrt(tris[:, :, 0] ** 2 + tris[:, :, 1] ** 2)
        tris = np.concatenate([tris, r[:, :, None]], axis=2)
        tris = _clip_tris_halfspace(tris, len(names), rxy,
                                    keep_ge=(sign_rxy in ("+", "gt")))
        tris = tris[:, :, : len(names)]
    for n, s, v in zip(comps, signs, vals):
        tris = _clip_tris_halfspace(tris, names.index(n), float(v),
                                    keep_ge=(s in ("+", "gt")))
    if rem_comps:
        keep = [i for i, n in enumerate(names) if n not in rem_comps]
        tris = tris[:, :, keep]
        names = [names[i] for i in keep]
    return tris_to_mef(tris, names, mef.label)


# ---------------------------------------------------------------------------
# binMEF (binMEF.cpp:419-474; data.rst "N-dimensional bins")
# ---------------------------------------------------------------------------

def bin_mef(mef: MEF, bin_comps: Sequence[str], bin_min: Sequence[float],
            bin_max: Sequence[float], n_bins: Sequence[int],
            cond_comp: Optional[str] = None, cond_val: float = 0.0,
            cond_sgn: str = "+", area_eps: float = 0.0,
            normalize: bool = False) -> np.ndarray:
    """Recursive N-coordinate area binning: each fragment landing in a bin of
    coordinate n is re-chopped in coordinate n+1.  Returns the dense
    [n_bins...] area array."""
    tris = mef_to_tris(mef)
    if cond_comp is not None:
        tris = _clip_tris_halfspace(tris, mef.names.index(cond_comp),
                                    cond_val, keep_ge=(cond_sgn in ("+",
                                                                    "gt")))
    ndim = mef.ndim
    ci = [mef.names.index(n) for n in bin_comps]
    # iterative, mostly-clip-free binning.  The
    # old recursive form clipped the WHOLE fragment set against every bin of
    # every coordinate (O(prod(nBins) x N) clip work, 30M-node-scale hostile,
    # Src/binMEF.cpp:419-455 does the same per-fragment).  Here each pass
    # assigns fragments fully inside one bin by index arithmetic and clips
    # ONLY bin-boundary-crossing fragments (a surface-measure subset); the
    # accumulated flat bin index rides along as an extra component column —
    # _clip_tris_halfspace lerps it exactly because it is vertex-constant.
    nt = len(tris)
    cur = np.concatenate([tris, np.zeros((nt, 3, 1))], axis=2)
    ID = cur.shape[2] - 1
    for depth, c in enumerate(ci):
        if len(cur) == 0:
            break
        nb = int(n_bins[depth])
        lo, hi = float(bin_min[depth]), float(bin_max[depth])
        edges = np.linspace(lo, hi, nb + 1)
        w = (hi - lo) / nb
        vc = cur[:, :, c]
        # per-vertex bin; a vertex exactly AT bin_max belongs to the last
        # bin (the recursive clipper's [edges[b], edges[b+1]] kept it there;
        # r5 review fix — floor() alone pushed it to bin nb and dropped it)
        bv = np.floor((vc - lo) / w)
        bv = np.where(vc == hi, nb - 1, bv).astype(np.int64)
        blo = bv.min(axis=1)
        bhi = bv.max(axis=1)
        inside = (blo == bhi) & (blo >= 0) & (blo < nb)
        keep = cur[inside]
        keep[:, :, ID] = keep[:, :, ID] * nb + blo[inside, None]
        parts = [keep]
        crossing = ~inside & (bhi >= 0) & (blo < nb)
        if crossing.any():
            ct = cur[crossing]
            cblo = np.maximum(blo[crossing], 0)
            cbhi = np.minimum(bhi[crossing], nb - 1)
            for b in range(nb):
                m = (cblo <= b) & (cbhi >= b)
                if not m.any():
                    continue
                frag = _clip_tris_halfspace(ct[m], c, edges[b], keep_ge=True)
                frag = _clip_tris_halfspace(frag, c, edges[b + 1],
                                            keep_ge=False)
                frag[:, :, ID] = frag[:, :, ID] * nb + b
                parts.append(frag)
        cur = np.concatenate(parts) if parts else cur[:0]
    prod = int(np.prod(n_bins))
    out = np.zeros(prod)
    if len(cur):
        ids = np.round(cur[:, 0, ID]).astype(np.int64)
        areas = _tri_areas(cur, ndim)
        tot = np.bincount(ids, weights=areas, minlength=prod)
        out = np.where(tot > area_eps, tot, 0.0)
    out = out.reshape(tuple(int(n) for n in n_bins))
    if normalize and out.sum() > 0:
        out /= out.sum()
    return out


# ---------------------------------------------------------------------------
# sliceMEF / isoMEF: iso-lines of a nodal field on the triangulation
# (isoMEF.cpp:33-132 marching triangles; sliceMEF.cpp:216-412)
# ---------------------------------------------------------------------------

def iso_lines(mef: MEF, comp_name: str, value: float):
    """Marching triangles: segments where field==value on the surface.
    Returns (seg_nodes [Ns,2,nvars], unique via edge-key dedup like the
    reference's PMap keyed by node pairs, isoMEF.cpp:33-100)."""
    c = mef.names.index(comp_name)
    f = mef.nodes[:, c]
    e = mef.elements
    fe = f[e]                                    # [ne,3]
    # edges of each triangle: (0,1),(1,2),(2,0); a segment connects the two
    # crossed edges of each triangle
    edge_pairs = [(0, 1), (1, 2), (2, 0)]
    cross = []
    for (i, j) in edge_pairs:
        fi, fj = fe[:, i], fe[:, j]
        cross.append((fi - value) * (fj - value) < 0.0)
    cross = np.stack(cross, axis=1)             # [ne,3]
    ncross = cross.sum(axis=1)
    sel = np.nonzero(ncross == 2)[0]
    if len(sel) == 0:
        return np.zeros((0, 2, mef.nodes.shape[1])), np.zeros((0, 2),
                                                              np.int64)
    keys = np.zeros((len(sel), 2), dtype=np.int64)
    vals = np.zeros((len(sel), 2, mef.nodes.shape[1]))
    nn = mef.n_nodes
    for s in range(2):
        # s-th crossed edge per selected triangle
        which = np.argmax(np.where(np.cumsum(cross[sel], axis=1) == s + 1,
                                   cross[sel], False), axis=1)
        i = np.array([edge_pairs[w][0] for w in which])
        j = np.array([edge_pairs[w][1] for w in which])
        ni = e[sel, i]
        nj = e[sel, j]
        fi, fj = f[ni], f[nj]
        t = np.clip((value - fi) / np.where(np.abs(fj - fi) > 1e-300,
                                            fj - fi, 1.0), 0, 1)
        vals[:, s] = mef.nodes[ni] + t[:, None] * (mef.nodes[nj]
                                                   - mef.nodes[ni])
        lo = np.minimum(ni, nj).astype(np.int64)
        hi = np.maximum(ni, nj).astype(np.int64)
        keys[:, s] = lo * nn + hi
    return vals, keys


def iso_mef(mef: MEF, comp_name: str, value: float) -> MEF:
    """Contour-on-surface -> segment MEF with exact edge-key node dedup."""
    vals, keys = iso_lines(mef, comp_name, value)
    flat_k = keys.reshape(-1)
    uniq, inv = np.unique(flat_k, return_inverse=True)
    first = np.full(len(uniq), len(flat_k), dtype=np.int64)
    np.minimum.at(first, inv, np.arange(len(flat_k)))
    nodes = vals.reshape(-1, vals.shape[-1])[first]
    elems = inv.reshape(-1, 2).astype(np.int32)
    return MEF(f"{comp_name}={value:g}", list(mef.names), nodes, elems)


def slice_mef(mef: MEF, direction: int, locs: Sequence[float]) -> List[MEF]:
    """Slice with axis-aligned planes -> polyline contour MEFs per location
    (sliceMEF.cpp:216-221,368-412)."""
    coord = mef.names[direction]
    return [iso_mef(mef, coord, loc) for loc in locs]


def assemble_polylines(seg_mef: MEF) -> List[np.ndarray]:
    """Chain segments into polylines (MakeCLines analog,
    isosurface.cpp:1159-1271).  Returns node-index chains; closed loops
    repeat their first node at the end.

    Array-based for manifold contours (every node on <=2 segments — the
    marching-squares output): directed-edge successor arrays + pointer
    doubling give each segment its (chain root, position) in O(ne log ne)
    vectorized work, no per-segment Python.  Junction nodes (degree >=3)
    fall back to the greedy walk."""
    segs = np.asarray(seg_mef.elements, dtype=np.int64)
    ne = len(segs)
    if ne == 0:
        return []
    n_nodes = int(segs.max()) + 1
    deg = np.bincount(segs.ravel(), minlength=n_nodes)
    if deg.max() > 2:
        return _assemble_polylines_walk(seg_mef)

    # directed edge ids: 2s = a->b (tail a, head b); 2s+1 = b->a.
    # incidence slot ids coincide: slot 2s holds a (tail of 2s, head of
    # 2s+1), slot 2s+1 holds b — so slot sl is the head of (sl^1) and the
    # tail of sl.
    m = 2 * ne
    order = np.argsort(segs.ravel(), kind="stable")
    starts_of = np.concatenate([[0], np.cumsum(deg)])[:-1]
    nxt = np.full(m, -1, dtype=np.int64)
    two = np.nonzero(deg == 2)[0]
    if len(two):
        s1 = order[starts_of[two]]       # the node's two incidence slots
        s2 = order[starts_of[two] + 1]
        nxt[s1 ^ 1] = s2                 # arrive via s1's segment, leave s2
        nxt[s2 ^ 1] = s1

    def _pred_of(nx):
        pr = np.full(m, -1, dtype=np.int64)
        has = nx >= 0
        pr[nx[has]] = np.nonzero(has)[0]
        return pr

    rounds = max(1, int(np.ceil(np.log2(max(m, 2)))) + 1)

    def _roots_depths(pr):
        """(root, depth) per directed edge by pointer doubling; edges in
        cycles come back with root == -1."""
        root = np.full(m, -1, dtype=np.int64)
        is_root = pr < 0
        root[is_root] = np.nonzero(is_root)[0]
        ptr = pr.copy()
        dist = (pr >= 0).astype(np.int64)
        for _ in range(rounds):
            live = np.nonzero(ptr >= 0)[0]
            if len(live) == 0:
                break
            p = ptr[live]
            rp = root[p]
            done = rp >= 0
            root[live[done]] = rp[done]
            dist[live] += dist[p]
            ptr[live] = ptr[p]
        return root, dist

    pred = _pred_of(nxt)
    root, depth = _roots_depths(pred)

    dropped_roots: set = set()
    closed_roots: set = set()
    if (root < 0).any():
        # cycles: each loop appears as two directed cycles with
        # complementary ids.  The cycle containing 2*min_segment has an
        # EVEN min id (the mirror\'s min is that id + 1) — keep even-min
        # cycles, cut every cycle just before its min edge, re-ladder.
        cyc = np.nonzero(root < 0)[0]
        mn = np.arange(m, dtype=np.int64)
        jump = nxt.copy()
        for _ in range(rounds):
            ok = jump[cyc] >= 0
            c = cyc[ok]
            mn[c] = np.minimum(mn[c], mn[jump[c]])
            jump[c] = jump[jump[c]]
        cyc_roots = np.unique(mn[cyc])
        closed_roots = set(int(r) for r in cyc_roots[(cyc_roots & 1) == 0])
        dropped_roots = set(int(r) for r in cyc_roots[(cyc_roots & 1) == 1])
        nxt[pred[cyc_roots]] = -1
        pred = _pred_of(nxt)
        root, depth = _roots_depths(pred)

    # one direction per open chain: the mirror chain\'s root is
    # (terminal ^ 1); keep the smaller root.  Loops already emit once.
    ordered = np.lexsort((depth, root))
    r_sorted = root[ordered]
    bounds = np.nonzero(np.diff(r_sorted))[0] + 1
    chain_starts = np.concatenate([[0], bounds])
    chain_ends = np.concatenate([bounds, [len(ordered)]]) - 1
    out: List[np.ndarray] = []
    for cs, ce in zip(chain_starts, chain_ends):
        r = int(r_sorted[cs])
        if r in dropped_roots:
            continue
        if r not in closed_roots and (int(ordered[ce]) ^ 1) < r:
            continue                     # mirror chain wins
        edges = ordered[cs: ce + 1]
        chain = np.empty(len(edges) + 1, dtype=np.int64)
        chain[0] = segs[r >> 1, r & 1]                  # tail of root
        chain[1:] = segs[edges >> 1, 1 - (edges & 1)]   # heads in order
        out.append(chain)
    return out


def _assemble_polylines_walk(seg_mef: MEF) -> List[np.ndarray]:
    """Greedy walk (handles junction nodes of any degree)."""
    from collections import defaultdict
    adj = defaultdict(list)
    for si, (a, b) in enumerate(seg_mef.elements):
        adj[int(a)].append((int(b), si))
        adj[int(b)].append((int(a), si))
    used = np.zeros(seg_mef.n_elts, dtype=bool)
    lines = []
    # start at odd-degree nodes (open lines) then loops
    starts = [n for n, nb in adj.items() if len(nb) == 1]
    starts += list(adj.keys())
    for s in starts:
        for nxt, si in adj[s]:
            if used[si]:
                continue
            chain = [s]
            cur, edge = nxt, si
            used[edge] = True
            chain.append(cur)
            progressing = True
            while progressing:
                progressing = False
                for nb, si2 in adj[cur]:
                    if not used[si2]:
                        used[si2] = True
                        cur = nb
                        chain.append(cur)
                        progressing = True
                        break
            lines.append(np.array(chain))
    return lines


# ---------------------------------------------------------------------------
# smoothMEF (smoothMEF.cpp:95-180)
# ---------------------------------------------------------------------------

def smooth_mef(mef: MEF, comps: Sequence[str], n_iter: int = 1) -> MEF:
    """Area-weighted neighbor averaging of node values: each node takes the
    area-weighted mean of the element averages of its incident elements."""
    e = mef.elements
    areas = mef.triangle_areas()
    nodes = mef.nodes.copy()
    ci = [mef.names.index(n) for n in comps]
    nn = mef.n_nodes
    for _ in range(n_iter):
        for c in ci:
            elt_mean = nodes[e, c].mean(axis=1)          # [ne]
            num = np.zeros(nn)
            den = np.zeros(nn)
            for k in range(3):
                np.add.at(num, e[:, k], elt_mean * areas)
                np.add.at(den, e[:, k], areas)
            nodes[:, c] = num / np.maximum(den, 1e-300)
    return MEF(mef.label, list(mef.names), nodes, mef.elements)
