"""``avgPlotfiles`` — ensemble average of N plotfiles with possibly
non-matching AMR hierarchies (/root/reference/Src/avgPlotfiles.cpp, 205 LoC;
docs: Docs/source/averagePlotfile.rst "averagePlotfileFlexible").

Output hierarchy: refined wherever ANY input is refined (union of level
footprints); each input is interpolated onto that hierarchy with the dense
fill (interp_type: "pc" = PCInterp, "linear" = cell-cons-linear analog,
avgPlotfiles.cpp:68-70) and the results averaged.

Ensemble streaming: the union footprint depends only on each file's
BoxArrays, so pass 0 reads HEADERS only; pass 1 streams the files through
the accumulator one at a time with read-ahead (io/prefetch.py) — peak
memory holds ~2 inputs plus the accumulator instead of the whole ensemble,
and file i+1's host parse overlaps file i's device fills.  (The reference
also loads one AmrData at a time, avgPlotfiles.cpp:118-160; here the
prefetch overlap is the addition.)
"""
from __future__ import annotations

from typing import List, Sequence

import jax.numpy as jnp
import numpy as np

from ..amr.box import Box, BoxArray, decompose
from ..amr.dense import DenseAmrState, _union_mask_np
from ..amr.geometry import Geometry
from ..amr.hierarchy import AmrMeta, AmrState
from ..io.plotfile import write_plotfile
from ..ops.dense_fill import fill_dense
from ..parmparse import ParmParse


def _accumulate_one(ds, lev, names, ubox, interp, acc, rvecs=None):
    """Fill one input's level onto the union bbox and add it into acc.
    An input that LACKS this level fills from its finest level and
    interpolates up (the reference's fillPatchFromPlt falls back to the
    file's coarser data, avgPlotfiles.cpp:82-84,180-186); rvecs[l] is the
    per-dim refinement between output levels l and l+1."""
    comps = [ds.comp(n) for n in names]
    if lev < ds.meta.n_levels:
        bbox = ds.lmeta[lev].bbox
        # grow this input's fill so it spans the union bbox; cells beyond
        # the input's own refinement get its coarse-interpolated values
        g = max([0] + [bbox.lo[d] - ubox.lo[d] for d in range(3)]
                + [ubox.hi[d] - bbox.hi[d] for d in range(3)])
        filled = np.asarray(fill_dense(ds, lev, g, comps=comps,
                                       interp=interp))
        gb = bbox.grow(g)
        sl = tuple(slice(ubox.lo[d] - gb.lo[d],
                         ubox.hi[d] - gb.lo[d] + 1) for d in range(3))
        acc += filled[(slice(None),) + sl]
        return
    from ..ops.dense_fill import _upsample_axis
    lf = ds.meta.n_levels - 1
    stages = [tuple(rv) for rv in rvecs[lf:lev]]
    rtot = tuple(int(np.prod([s[d] for s in stages])) for d in range(3))
    cbox = ubox.coarsen(rtot)
    bboxf = ds.lmeta[lf].bbox
    # one spare coarse cell so _upsample_axis's edge clamp never shows
    g = max([1] + [bboxf.lo[d] - cbox.lo[d] + 1 for d in range(3)]
            + [cbox.hi[d] - bboxf.hi[d] + 1 for d in range(3)])
    filled = fill_dense(ds, lf, g, comps=comps, interp=interp)
    gb = bboxf.grow(g)
    work_box = cbox.grow(1)
    sl = tuple(slice(work_box.lo[d] - gb.lo[d],
                     work_box.hi[d] - gb.lo[d] + 1) for d in range(3))
    cur = filled[(slice(None),) + sl]
    for rv in stages:
        for d in range(3):
            if rv[d] > 1:
                cur = _upsample_axis(cur, d, int(rv[d]), interp)
        work_box = work_box.refine(rv)
    sl = tuple(slice(ubox.lo[d] - work_box.lo[d],
                     ubox.hi[d] - work_box.lo[d] + 1) for d in range(3))
    acc += np.asarray(cur[(slice(None),) + sl])


def average_states(states: Sequence[AmrState], names: Sequence[str],
                   interp: str = "linear",
                   output_max_level: int = None):
    """In-memory ensemble average (Python-API path; the CLI streams via
    :func:`average_paths`).  Returns per-level union data/footprints."""
    metas = [st.meta for st in states]
    # MAX levels (avgPlotfiles.cpp:83): shallower inputs interpolate up
    n_lev = max(m.n_levels for m in metas)
    if output_max_level is not None:
        n_lev = min(n_lev, output_max_level + 1)
    deep = max(metas, key=lambda m: m.n_levels)
    for m in metas:
        nl = min(n_lev, m.n_levels)
        if m.geoms[0].domain != metas[0].geoms[0].domain:
            raise ValueError("avgPlotfiles: domains differ")
        if m.ref_ratio[: nl - 1] != deep.ref_ratio[: nl - 1]:
            raise ValueError("avgPlotfiles: ref ratios differ")
    ndim2 = getattr(deep, "ndim2", False)
    rvecs = [(int(r), int(r), 1 if ndim2 else int(r))
             for r in deep.ref_ratio[: n_lev - 1]]

    denses = [DenseAmrState.from_batched(st) for st in states]
    out_data, lmeta = [], []
    for lev in range(n_lev):
        bbs = [ds.lmeta[lev].bbox for ds in denses
               if lev < ds.meta.n_levels]
        ubox = Box(tuple(min(b.lo[d] for b in bbs) for d in range(3)),
                   tuple(max(b.hi[d] for b in bbs) for d in range(3)))
        union = np.zeros(ubox.shape, dtype=bool)
        acc = np.zeros((len(names),) + ubox.shape)
        for ds in denses:
            _accumulate_one(ds, lev, names, ubox, interp, acc, rvecs)
            if lev < ds.meta.n_levels:
                bbox = ds.lmeta[lev].bbox
                msl = tuple(slice(bbox.lo[d] - ubox.lo[d],
                                  bbox.hi[d] - ubox.lo[d] + 1)
                            for d in range(3))
                union[msl] |= ds.in_level_mask_np(lev)
        acc /= len(denses)
        out_data.append(jnp.asarray(acc))
        lmeta.append((ubox, union))
    return out_data, lmeta, deep, n_lev


def average_paths(args: dict, paths: Sequence[str], names, interp: str,
                  output_max_level, depth: int = 1):
    """Streaming ensemble average: union footprints from HEADERS, then one
    prefetched pass accumulating each file (module docstring).  Returns
    (out_data, lmeta, meta0, n_lev, names, time0)."""
    from ..io.plotfile import PlotfileReader
    from ..io.prefetch import iter_states

    readers = [PlotfileReader(p) for p in paths]
    # output is refined wherever ANY input is refined: MAX levels across
    # the ensemble (avgPlotfiles.cpp:83 nlevels = max(getNlev()); r5 review
    # fix — min() silently dropped the deeper files' refinement), with
    # shallower files coarse-interpolated onto the missing levels
    n_lev = max(r.meta.n_levels for r in readers)
    if output_max_level is not None:
        n_lev = min(n_lev, output_max_level + 1)
    deep = max(readers, key=lambda r: r.meta.n_levels).meta
    m0 = readers[0].meta
    for r in readers:
        nl = min(n_lev, r.meta.n_levels)
        if r.meta.geometry(0).domain != m0.geometry(0).domain:
            raise ValueError("avgPlotfiles: domains differ")
        if (list(r.meta.ref_ratio[: nl - 1])
                != list(deep.ref_ratio[: nl - 1])):
            raise ValueError("avgPlotfiles: ref ratios differ")
    # per-dim refinement between output levels, from the deepest file's
    # level domains (z stays 1 for promoted DIM=2 plotfiles)
    ndim2 = deep.ndim == 2
    rvecs = []
    for l in range(n_lev - 1):
        rr = int(deep.ref_ratio[l])
        rvecs.append((rr, rr, 1 if ndim2 else rr))
    if names is None:
        # cross-check shared variables (avgPlotfiles.cpp:77-115)
        names = [n for n in readers[0].var_names
                 if all(n in r.var_names for r in readers)]

    # ---- pass 0: union bboxes + footprints, from box metadata alone -------
    def ba3(r, lev):   # DIM=2 plotfiles promote to the nz=1 in-memory model
        ba = r.box_array(lev)
        if r.meta.ndim == 2:
            ba = BoxArray([Box(b.lo + (0,), b.hi + (0,)) for b in ba])
        return ba

    uboxes, unions = [], []
    for lev in range(n_lev):
        # only files that HAVE this level contribute footprint (the others
        # are interpolated onto it, they do not refine it)
        bas = [ba3(r, lev) for r in readers if lev < r.meta.n_levels]
        bbs = [ba.minimal_box() for ba in bas]
        ubox = Box(tuple(min(b.lo[d] for b in bbs) for d in range(3)),
                   tuple(max(b.hi[d] for b in bbs) for d in range(3)))
        union = np.zeros(ubox.shape, dtype=bool)
        for ba in bas:
            union |= _union_mask_np(ba, ubox)
        uboxes.append(ubox)
        unions.append(union)
    del readers

    # ---- pass 1: stream files through the accumulator ----------------------
    accs = [np.zeros((len(names),) + ub.shape) for ub in uboxes]
    meta0 = time0 = None
    for _p, st in iter_states(args, paths, names=list(names),
                              dtype=np.float64, depth=depth):
        if meta0 is None:
            meta0, time0 = st.meta, st.meta.time
        ds = DenseAmrState.from_batched(st)
        for lev in range(n_lev):
            _accumulate_one(ds, lev, names, uboxes[lev], interp, accs[lev],
                            rvecs)
    out_data = [jnp.asarray(a / len(paths)) for a in accs]
    lmeta = [(ub, un) for ub, un in zip(uboxes, unions)]
    return out_data, lmeta, meta0, n_lev, list(names), time0, rvecs


def write_averaged(path: str, out_data, lmeta, meta0, n_lev,
                   names, time, max_grid_size: int = 32,
                   rvecs=None) -> None:
    # output geoms span n_lev levels even when meta0 (the FIRST file) has
    # fewer: refine level 0 through the per-stage ratios
    if rvecs is None:
        out_geoms = list(meta0.geoms[:n_lev])
        out_rr = list(meta0.ref_ratio[: n_lev - 1])
    else:
        out_geoms = [meta0.geoms[0]]
        for rv in rvecs[: n_lev - 1]:
            out_geoms.append(out_geoms[-1].refine(rv))
        out_rr = [int(rv[0]) for rv in rvecs[: n_lev - 1]]
    geoms, bas, fabs_all = [], [], []
    for lev in range(n_lev):
        ubox, union = lmeta[lev]
        dense = np.asarray(out_data[lev], dtype=np.float64)
        boxes, fabs = [], []
        for b in decompose(ubox, max_grid_size):
            sl = tuple(slice(b.lo[d] - ubox.lo[d], b.hi[d] - ubox.lo[d] + 1)
                       for d in range(3))
            m = union[sl]
            if not m.any():
                continue
            if not m.all():
                idx = np.argwhere(m)
                lo, hi = idx.min(axis=0), idx.max(axis=0)
                b = Box(tuple(b.lo[d] + lo[d] for d in range(3)),
                        tuple(b.lo[d] + hi[d] for d in range(3)))
                sl = tuple(slice(b.lo[d] - ubox.lo[d],
                                 b.hi[d] - ubox.lo[d] + 1) for d in range(3))
            boxes.append(b)
            fabs.append(np.ascontiguousarray(dense[(slice(None),) + sl]))
        geoms.append(out_geoms[lev])
        bas.append(BoxArray(boxes))
        fabs_all.append(fabs)
    if getattr(meta0, "ndim2", False):   # demote back to a DIM=2 plotfile
        geoms = [Geometry(Box(g.domain.lo[:2], g.domain.hi[:2]),
                          g.prob_lo[:2], g.prob_hi[:2],
                          g.is_periodic[:2], g.coord_sys) for g in geoms]
        bas = [BoxArray([Box(b.lo[:2], b.hi[:2]) for b in ba])
               for ba in bas]
        fabs_all = [[f[..., 0] for f in fabs] for fabs in fabs_all]
    write_plotfile(path, names, time, geoms, out_rr, bas, fabs_all)


def main(args: dict) -> None:
    """CLI: avgPlotfiles infile=<plt>... [vars=all] [interp_type=1|2]
    [output_max_level=] [output_max_grid_size=32] outfile=
    [prefetch=1 — ensemble read-ahead (io/prefetch.py); 0 = serial]"""
    pp = ParmParse(args)
    infiles = pp.get_str_list("infiles" if pp.contains("infiles") else "infile")
    # reference default is interp_type=1 / PCInterp (avgPlotfiles.cpp:69;
    # r5 review fix: this defaulted to 2/linear)
    itype = pp.query_int("interp_type", 1)
    interp = "pc" if itype == 1 else "linear"
    names = (pp.query_str_list("variables", None)
             or pp.query_str_list("vars", None))
    from ..io.prefetch import query_prefetch
    out_data, lmeta, meta0, n_lev, names, time0, rvecs = average_paths(
        args, infiles, names, interp, pp.query_int("output_max_level", None),
        depth=query_prefetch(pp))
    outfile = pp.query_str("outfile", infiles[0] + "_avg")
    write_averaged(outfile, out_data, lmeta, meta0, n_lev, names, time0,
                   pp.query_int("output_max_grid_size", 32), rvecs=rvecs)
    print(f"wrote {outfile}")
