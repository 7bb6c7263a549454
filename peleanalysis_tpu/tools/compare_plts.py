"""``fcompare`` / ``fextrema`` — plotfile diff and extrema reporting.

Not part of PeleAnalysis itself, but every Pele workflow leans on AMReX's
``fcompare``/``fextrema`` executables (amrex/Tools/Plotfile) for regression
diffs, and a standalone framework needs them: fcompare reports per-comp
absolute and relative L-inf/L-2 differences of two plotfiles on matching
hierarchies; fextrema reports per-comp min/max over valid (uncovered)
cells.

Everything runs in HOST numpy at the file's native precision (f64 FABs
stay f64) on purpose: jax without x64 would silently downcast to f32,
hiding exactly the 1e-9-relative drifts fcompare exists to catch.  The work is trivial; no device or jax involvement at all.
"""
from __future__ import annotations

import numpy as np

from ..io.plotfile import PlotfileReader
from ..parmparse import ParmParse


def _valid_mask(box, fine_boxes, ratio) -> np.ndarray:
    """True where `box` (at level l) is NOT covered by the level-(l+1)
    boxes coarsened by `ratio`.  Dimension-generic, pure numpy."""
    nd = len(box.lo)
    m = np.ones(box.shape[:nd], bool)
    for fb in fine_boxes:
        lo = [max(fb.lo[d] // ratio, box.lo[d]) for d in range(nd)]
        hi = [min(fb.hi[d] // ratio, box.hi[d]) for d in range(nd)]
        if all(lo[d] <= hi[d] for d in range(nd)):
            m[tuple(slice(lo[d] - box.lo[d], hi[d] - box.lo[d] + 1)
                    for d in range(nd))] = False
    return m


def _per_box_valid(r: PlotfileReader):
    """Yield (lev, ibox, valid_mask) over every box of every level."""
    m = r.meta
    for lev in range(m.n_levels):
        boxes = list(r.box_array(lev))
        if lev < m.n_levels - 1:
            fine = list(r.box_array(lev + 1))
            ratio = m.ref_ratio[lev]
        else:
            fine, ratio = [], 1
        for i, b in enumerate(boxes):
            yield lev, i, _valid_mask(b, fine, ratio)


def compare_plotfiles(r1: PlotfileReader, r2: PlotfileReader, names):
    """Per-comp (abs_linf, rel_linf, abs_l2) over valid cells, native
    precision.  rel uses |a| as the denominator (fcompare convention)."""
    i1 = [r1.var_index(n) for n in names]
    i2 = [r2.var_index(n) for n in names]
    nc = len(names)
    linf = np.zeros(nc)
    l2 = np.zeros(nc)
    amax = np.zeros(nc)
    for lev, ib, valid in _per_box_valid(r1):
        fa = r1.read_box(lev, ib, i1).astype(np.float64, copy=False)
        fb = r2.read_box(lev, ib, i2).astype(np.float64, copy=False)
        for k in range(nc):
            va = fa[k][valid]
            d = np.abs(va - fb[k][valid])
            if d.size:
                linf[k] = max(linf[k], d.max())
                l2[k] += (d * d).sum()
                amax[k] = max(amax[k], np.abs(va).max())
    rel = linf / np.maximum(amax, 1e-300)
    return linf, rel, np.sqrt(l2)


def extrema_plotfile(r: PlotfileReader, names):
    idx = [r.var_index(n) for n in names]
    nc = len(names)
    lo = np.full(nc, np.inf)
    hi = np.full(nc, -np.inf)
    for lev, ib, valid in _per_box_valid(r):
        f = r.read_box(lev, ib, idx).astype(np.float64, copy=False)
        for k in range(nc):
            v = f[k][valid]
            if v.size:
                lo[k] = min(lo[k], v.min())
                hi[k] = max(hi[k], v.max())
    return lo, hi


def main(args: dict) -> None:
    """CLI: fcompare infile1= infile2= [vars=common] [rtol=] [atol=]
         | fextrema infile= [vars=all]
    fcompare exits nonzero when any comp exceeds rtol/atol (if given)."""
    pp = ParmParse(args)
    tool = args.get("_tool", ["fcompare"])[0]
    if tool == "fextrema":
        infile = pp.get_str("infile")
        r = PlotfileReader(infile)
        names = pp.query_str_list("vars", r.var_names)
        lo, hi = extrema_plotfile(r, names)
        w = max(len(n) for n in names)
        print(f" plotfile = {infile}")
        print(f" time     = {r.meta.time}")
        print(f" {'variable'.ljust(w)}   {'minimum value':>20} "
              f"{'maximum value':>20}")
        for n, a, b in zip(names, lo, hi):
            print(f" {n.ljust(w)}   {a:20.10e} {b:20.10e}")
        return

    f1, f2 = pp.get_str("infile1"), pp.get_str("infile2")
    r1, r2 = PlotfileReader(f1), PlotfileReader(f2)
    names = pp.query_str_list(
        "vars", [n for n in r1.var_names if n in r2.var_names])
    if not names:
        raise ValueError(f"fcompare: no common comps between {f1} and {f2}")
    for fn, r in ((f1, r1), (f2, r2)):
        missing = [n for n in names if n not in r.var_names]
        if missing:
            raise ValueError(f"fcompare: comps not in {fn}: {missing}")
    # AMReX fcompare aborts unless the BoxArrays agree; matching minimal
    # bboxes with different box unions would diff valid cells against holes
    n1, n2 = r1.meta.n_levels, r2.meta.n_levels
    if n1 != n2 or any(r1.box_array(l) != r2.box_array(l)
                       for l in range(n1)):
        raise ValueError("fcompare: BoxArrays are not the same")
    linf, rel, l2 = compare_plotfiles(r1, r2, names)
    w = max(len(n) for n in names)
    print(f" {'variable'.ljust(w)}   {'absolute error':>16} "
          f"{'relative error':>16} {'L2 error':>16}")
    for n, ai, ri, l2i in zip(names, linf, rel, l2):
        print(f" {n.ljust(w)}   {ai:16.8e} {ri:16.8e} {l2i:16.8e}")
    rtol = pp.query_float("rtol", None)
    atol = pp.query_float("atol", None)
    if rtol is not None and (rel > rtol).any():
        raise SystemExit(f"fcompare: relative error exceeds rtol={rtol}")
    if atol is not None and (linf > atol).any():
        raise SystemExit(f"fcompare: absolute error exceeds atol={atol}")
    if (linf == 0).all():
        print(" PLOTFILES AGREE")
