"""``jpdf`` — joint PDFs of every pair of variables.

JAX replacement for PeleAnalysis Src/jpdf.cpp (1075 LoC):
for each of the n(n-1)/2 variable pairs, a volume-weighted nBins^2 joint
histogram over all uncovered cells of all levels (out-of-range values clamp
into edge bins, jpdf.cpp:489-496), plus conditional-mean accumulators
binX1/binX2.  Features reproduced:

  * per-variable min/max scan with ``useminmax%i`` overrides
    (jpdf.cpp:296-326)
  * conditioning window on cVar incl. normalized (norm_cVal) and c(1-c)
    (do_conditioning=2) modes (jpdf.cpp:110-152, 476-487)
  * derived "Stoichiometry" variable 0.5*sum(X*H)/sum(X*O) from per-variable
    H/O atom counts (jpdf.cpp:193-243, 388-420)
  * writers: gnuplot/matlab/tecplot/fab/scatter/2-D plotfile with the
    reference's normalization — binX /= bin then bin /= domainVol
    (jpdf.cpp:560-740); multi-file ``do_average`` pass (jpdf.cpp:935-1049)
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..amr.box import Box
from ..amr.dense import DenseAmrState
from ..amr.geometry import Geometry
from ..amr.hierarchy import AmrState
from ..io.fab import write_fab
from ..ops.stats import joint_pdf
from ..parmparse import ParmParse
from functools import partial
import jax


@partial(jax.jit, static_argnames=("vols", "bounds", "nbins"))
def _jpdf_all(f1s, f2s, ms, vols, bounds, nbins):
    import jax.numpy as jnp
    from ..ops.stats import masked_mean
    v1min, v1max, v2min, v2max = bounds
    # Global masked means as moment shifts (float32-safe X1/X2 accumulation;
    # see ops/stats.py).  Use the level-0 mean — any near-mean shift works.
    c1 = masked_mean(f1s[0], ms[0], vols[0])
    c2 = masked_mean(f2s[0], ms[0], vols[0])
    b = bx1 = bx2 = 0.0
    for lev in range(len(f1s)):
        bb, b1, b2 = joint_pdf(f1s[lev], f2s[lev], vols[lev], ms[lev],
                               v1min, v1max, v2min, v2max, nbins,
                               shift1=c1, shift2=c2)
        b, bx1, bx2 = b + bb, bx1 + b1, bx2 + b2
    return b, bx1, bx2, c1, c2

@partial(jax.jit, static_argnames=("nbins", "pairs"))
def _jpdf_multi_all(vals_list, ms, vols, lo, hi, nbins, pairs):
    """All levels x all pairs in one dispatch (r5): per-variable moment
    shifts from the level-0 masked means, then joint_pdf_multi per level
    accumulated.  Returns (b, bx1', bx2', shifts)."""
    import jax.numpy as jnp
    from ..ops.stats import joint_pdf_multi, masked_mean
    nv = vals_list[0].shape[0]
    sh = jnp.stack([masked_mean(vals_list[0][v], ms[0], vols[0])
                    for v in range(nv)])
    b = bx1 = bx2 = 0.0
    for lev in range(len(vals_list)):
        bb, b1, b2 = joint_pdf_multi(vals_list[lev], vols[lev], ms[lev],
                                     lo, hi, nbins, pairs, shifts=sh)
        b, bx1, bx2 = b + bb, bx1 + b1, bx2 + b2
    return b, bx1, bx2, sh


def compute_jpdf_pairs(dstate: DenseAmrState, field_levels, lo, hi,
                       nbins, pairs, cond_levels=None):
    """All-pairs jpdf accumulation over all levels: ONE dispatch + ONE
    fetch for the whole n(n-1)/2 pair family (the per-pair path made one
    dispatch and one fetch per pair).  field_levels: [nv] of [lev] -> [*bbox];
    lo/hi: [nv].  Returns (b, bx1, bx2) each [npairs, nbins, nbins]
    float64 with raw (unshifted) bx columns."""
    import jax.numpy as jnp
    n_lev = dstate.meta.n_levels
    nv = len(field_levels)
    vols = tuple(float(np.prod(dstate.meta.geoms[lev].dx))
                 for lev in range(n_lev))
    masks = []
    for lev in range(n_lev):
        m = dstate.valid_mask(lev)
        if cond_levels is not None:
            m = m & cond_levels[lev]
        masks.append(m)
    vals_list = [jnp.stack([field_levels[v][lev] for v in range(nv)])
                 for lev in range(n_lev)]
    edt = np.float64 if vals_list[0].dtype == np.float64 else np.float32
    b, bx1_s, bx2_s, sh = jax.device_get(_jpdf_multi_all(
        vals_list, masks, vols, np.asarray(lo, edt),
        np.asarray(hi, edt), nbins, tuple(map(tuple, pairs))))
    b64 = np.asarray(b, np.float64)
    sh = np.asarray(sh, np.float64)
    ii = np.asarray([p[0] for p in pairs])
    jj = np.asarray([p[1] for p in pairs])
    bx1 = np.asarray(bx1_s, np.float64) + sh[ii][:, None, None] * b64
    bx2 = np.asarray(bx2_s, np.float64) + sh[jj][:, None, None] * b64
    return b64, bx1, bx2


SMALL = 1.0e-7


def valid_minmax(dstate: DenseAmrState, comp: int) -> Tuple[float, float]:
    import jax.numpy as jnp
    lo, hi = np.inf, -np.inf
    for lev in range(dstate.meta.n_levels):
        v = dstate.data[lev][comp]
        m = dstate.valid_mask(lev)
        lo = min(lo, float(jnp.min(jnp.where(m, v, np.inf))))
        hi = max(hi, float(jnp.max(jnp.where(m, v, -np.inf))))
    return lo, hi


def stoichiometry_field(dstate: DenseAmrState, var_names: Sequence[str],
                        h_list: Sequence[int], o_list: Sequence[int]):
    """0.5 * sum_v X_v*H_v / sum_v X_v*O_v per level (jpdf.cpp:410-417)."""
    import jax.numpy as jnp
    out = []
    idx = [dstate.comp(n) for n in var_names]
    h = np.asarray(h_list, dtype=np.float64)
    o = np.asarray(o_list, dtype=np.float64)
    for lev in range(dstate.meta.n_levels):
        X = dstate.data[lev][np.asarray(idx)]
        hi = jax.lax.Precision.HIGHEST
        sumH = jnp.tensordot(jnp.asarray(h, X.dtype), X, axes=1,
                             precision=hi)
        sumO = jnp.tensordot(jnp.asarray(o, X.dtype), X, axes=1,
                             precision=hi)
        out.append(0.5 * sumH / sumO)
    return out


def compute_jpdf_pair(dstate: DenseAmrState, f1_levels, f2_levels,
                      v1min, v1max, v2min, v2max, nbins,
                      cond_levels=None):
    """Accumulate one pair over all levels in one jitted call.
    f*_levels: [lev] -> [*bbox]."""
    n_lev = dstate.meta.n_levels
    vols = tuple(float(np.prod(dstate.meta.geoms[lev].dx))
                 for lev in range(n_lev))
    masks = []
    for lev in range(n_lev):
        m = dstate.valid_mask(lev)
        if cond_levels is not None:
            m = m & cond_levels[lev]
        masks.append(m)
    b, bx1_s, bx2_s, c1, c2 = jax.device_get(_jpdf_all(
        list(f1_levels), list(f2_levels), masks, vols,
        (float(v1min), float(v1max), float(v2min), float(v2max)), nbins))
    b64 = np.asarray(b, np.float64)
    bx1 = np.asarray(bx1_s, np.float64) + np.float64(c1) * b64
    bx2 = np.asarray(bx2_s, np.float64) + np.float64(c2) * b64
    return b64, bx1, bx2


def normalize_pair(b, bx1, bx2, v1min, v1max, v2min, v2max, domain_vol):
    """Reference normalization (jpdf.cpp:572-588): binX/=bin (bin centers
    where empty), then bin/=domainVol."""
    nbins = b.shape[0]
    dv1 = (v1max - v1min) / nbins
    dv2 = (v2max - v2min) / nbins
    c1 = v1min + dv1 * (0.5 + np.arange(nbins))
    c2 = v2min + dv2 * (0.5 + np.arange(nbins))
    C1, C2 = np.meshgrid(c1, c2, indexing="ij")
    nz = b > 0
    bx1 = np.where(nz, bx1 / np.where(nz, b, 1.0), C1)
    bx2 = np.where(nz, bx2 / np.where(nz, b, 1.0), C2)
    return b / domain_vol, bx1, bx2, C1, C2


# ---------------------------------------------------------------------------
# writers (formats per jpdf.cpp:595-740)
# ---------------------------------------------------------------------------

def write_gnuplot(path, C1, C2, b):
    with open(path, "w") as f:
        for i in range(b.shape[0]):
            for j in range(b.shape[1]):
                f.write(f"{C1[i, j]:e} {C2[i, j]:e} {b[i, j]:e}\n")


def write_matlab(base, n1, n2, C1, C2, b, bx1, bx2):
    np.savetxt(f"{base}/Pdf_{n1}_{n2}.dat", b, fmt="%e")
    np.savetxt(f"{base}/Pdf_{n1}_x.dat", C1[:, 0], fmt="%e")
    np.savetxt(f"{base}/Pdf_{n2}_x.dat", C2[0, :], fmt="%e")
    np.savetxt(f"{base}/PdfX1_{n1}_{n2}.dat", bx1, fmt="%e")
    np.savetxt(f"{base}/PdfX2_{n1}_{n2}.dat", bx2, fmt="%e")


def write_tecplot(path, n1, n2, C1, C2, b):
    nbins = b.shape[0]
    with open(path, "w") as f:
        f.write(f"VARIABLES = {n1} {n2} logpdf pdf\n")
        f.write(f"ZONE N={nbins*nbins} E={(nbins-1)*(nbins-1)} "
                "F=FEPOINT ET=QUADRILATERAL\n")
        for i in range(nbins):
            for j in range(nbins):
                p = b[i, j]
                f.write(f"{C1[i,j]:e} {C2[i,j]:e} {np.log(p + SMALL):e} "
                        f"{p:e}\n")
        for i in range(nbins - 1):
            for j in range(nbins - 1):
                i1 = i * nbins + j + 1
                i2 = (i + 1) * nbins + j + 1
                i3 = (i + 1) * nbins + (j + 1) + 1
                i4 = i * nbins + (j + 1) + 1
                f.write(f"{i1} {i2} {i3} {i4}\n")


def write_fab_pdf(path, C1, C2, b):
    nbins = b.shape[0]
    data = np.stack([C1, C2, np.log(b + SMALL), b])[..., None]  # z extent 1
    with open(path, "wb") as f:
        write_fab(f, Box((0, 0, 0), (nbins - 1, nbins - 1, 0)), data)


def write_scatter(path, C1, C2, b):
    with open(path, "w") as f:
        for i in range(b.shape[0]):
            for j in range(b.shape[1]):
                if b[i, j] > 0:
                    f.write(f"{C1[i,j]:e} {C2[i,j]:e}\n")


def write_pdf_plotfile(path, n1, n2, v1min, v1max, v2min, v2max, b):
    """2-D plotfile rendering of the pdf (jpdf.cpp:733-.. analog): a
    single-level nbins x nbins x 1 grid in (v1,v2) space."""
    from ..io.plotfile import write_plotfile
    from ..amr.box import BoxArray
    nbins = b.shape[0]
    dom = Box((0, 0, 0), (nbins - 1, nbins - 1, 0))
    geom = Geometry(dom, (v1min, v2min, 0.0), (v1max, v2max, 1.0),
                    (False, False, False))
    fab = np.stack([np.log(b + SMALL), b])[..., None]
    write_plotfile(path, ["logpdf", "pdf"], 0.0, [geom], [],
                   [BoxArray([dom])], [[fab]])


def _protect(name: str) -> str:
    return name.replace("/", "_")


def main(args: dict) -> None:
    """CLI: jpdf infile=<plt>... vars=<name>... [nBins=64] [useminmax%i=lo hi]
    [do_conditioning=0|1|2 cVar=i norm_cVal=0 cNormMin/Max cMin cMax]
    [do_stoichiometry=0 Hlist=... Olist=...] [do_average=0]
    [output_gnuplot/matlab/tecplot/fab/scatter/plotfile=..] [outSuffix=]
    [prefetch=1 — multi-file read-ahead (io/prefetch.py); 0 = serial]"""
    pp = ParmParse(args)
    infiles = pp.get_str_list("infiles" if pp.contains("infiles") else "infile")
    nbins = pp.query_int("nBins", 64)
    var_in = pp.get_str_list("vars")
    do_stoich = pp.query_bool("do_stoichiometry", False)
    do_avg = pp.query_bool("do_average", False)
    out_suffix = pp.query_str("outSuffix", "")
    outputs = {k: pp.query_bool("output_" + k, k == "plotfile")
               for k in ("gnuplot", "matlab", "tecplot", "fab", "scatter",
                         "plotfile")}
    finest = pp.query_int("finestLevel", None)

    names = list(var_in)
    if do_stoich:
        h_list = pp.get_int_list("Hlist")
        o_list = pp.get_int_list("Olist")
        names_all = names + ["Stoichiometry"]
    else:
        names_all = names

    do_cond = pp.query_int("do_conditioning", 0)
    cvar = pp.query_int("cVar", 0)
    norm_c = pp.query_int("norm_cVal", 0) or (do_cond == 2)
    cnmin = pp.query_float("cNormMin", 0.0)
    cnmax = pp.query_float("cNormMax", 1.0)
    cmin = pp.query_float("cMin", 0.0)
    cmax = pp.query_float("cMax", 1.0)

    nvars = len(names_all)
    npairs = nvars * (nvars - 1) // 2
    avg = [None] * npairs

    from ..amr.cluster import needs_clustering, sparse_stats_parts
    from ..io.prefetch import iter_states, query_prefetch
    dt = {"float64": np.float64, "f64": np.float64,
          "double": np.float64, "float32": np.float32,
          "f32": np.float32, "single": np.float32}[
        pp.query_str("dtype", "float32")]
    # time series: next file's host parse + upload overlaps this file's
    # device work (io/prefetch.py; prefetch=0 restores the serial loop)
    for plt, st in iter_states(args, infiles, names=names,
                               max_level=finest, dtype=dt,
                               depth=query_prefetch(pp)):
        if (st.meta.n_levels > 1 and needs_clustering(st.meta.bas[-1])
                and not pp.query_bool("force_dense", False)):
            # sparse refinement: coarse levels once (global covered mask) +
            # fine clusters; jpdf weights are physical cell volumes, so no
            # rescale is needed across parts
            print("jpdf: sparse refinement -> clustered path")
            ds_c, clusters, _r = sparse_stats_parts(st)
            part_states = [ds_c] + clusters
        else:
            from ..session import dense_state
            part_states = [dense_state(args, st)]
        parts = []
        for ds in part_states:
            fields = {n: [ds.data[lev][ds.comp(n)]
                          for lev in range(ds.meta.n_levels)] for n in names}
            if do_stoich:
                fields["Stoichiometry"] = stoichiometry_field(
                    ds, names, h_list, o_list)
            cond_levels = None
            if do_cond:
                cname = names_all[cvar]
                cond_levels = []
                for lev in range(ds.meta.n_levels):
                    cval = fields[cname][lev]
                    if norm_c:
                        cval = (cval - cnmin) / (cnmax - cnmin)
                    if do_cond == 2:
                        cval = cval * (1.0 - cval)
                    cond_levels.append((cval >= cmin) & (cval <= cmax))
            parts.append((ds, fields, cond_levels))

        vmin, vmax = {}, {}
        for i, n in enumerate(names_all):
            if n == "Stoichiometry":
                vmin[n], vmax[n] = 0.0, 2.0
            else:
                mms = [valid_minmax(ds, ds.comp(n)) for ds, _, _ in parts]
                vmin[n] = min(lo for lo, _ in mms)
                vmax[n] = max(hi for _, hi in mms)
            mm = pp.query_float_list(f"useminmax{i+1}", None)
            if mm:
                vmin[n], vmax[n] = mm[0], mm[1]

        g = st.meta.geoms[0]
        domain_vol = float(np.prod([h - l for l, h in
                                    zip(g.prob_lo, g.prob_hi)]))
        base = plt + out_suffix
        if out_suffix and not os.path.isdir(base):
            os.makedirs(base, exist_ok=True)
        if not out_suffix:
            base = plt
        os.makedirs(base, exist_ok=True)

        # all pairs in ONE dispatch + ONE fetch per part (r5: shared
        # per-variable one-hots; the old loop paid a roundtrip per pair)
        pairs = tuple((a, bvar) for a in range(nvars)
                      for bvar in range(a + 1, nvars))
        lo = [vmin[n] for n in names_all]
        hi = [vmax[n] for n in names_all]
        bP = bx1P = bx2P = 0.0
        for ds, fields, cond_levels in (parts if pairs else []):
            bb, b1, b2 = compute_jpdf_pairs(
                ds, [fields[n] for n in names_all], lo, hi, nbins, pairs,
                cond_levels)
            bP, bx1P, bx2P = bP + bb, bx1P + b1, bx2P + b2
        ipair = 0
        for a in range(nvars):
            for bvar in range(a + 1, nvars):
                n1, n2 = names_all[a], names_all[bvar]
                b, bx1, bx2 = bP[ipair], bx1P[ipair], bx2P[ipair]
                if do_avg:
                    if avg[ipair] is None:
                        avg[ipair] = [np.zeros_like(b) for _ in range(3)]
                    avg[ipair][0] += b
                    avg[ipair][1] += bx1
                    avg[ipair][2] += bx2
                bn, bx1n, bx2n, C1, C2 = normalize_pair(
                    b, bx1, bx2, vmin[n1], vmax[n1], vmin[n2], vmax[n2],
                    domain_vol)
                _emit(outputs, base, _protect(n1), _protect(n2), n1, n2,
                      C1, C2, bn, bx1n, bx2n,
                      vmin[n1], vmax[n1], vmin[n2], vmax[n2])
                ipair += 1

    if do_avg:
        base = infiles[0] + out_suffix + "_avg"
        os.makedirs(base, exist_ok=True)
        ipair = 0
        for a in range(nvars):
            for bvar in range(a + 1, nvars):
                n1, n2 = names_all[a], names_all[bvar]
                b, bx1, bx2 = avg[ipair]
                bn, bx1n, bx2n, C1, C2 = normalize_pair(
                    b, bx1, bx2, vmin[n1], vmax[n1], vmin[n2], vmax[n2],
                    domain_vol * len(infiles))
                _emit(outputs, base, _protect(n1), _protect(n2), n1, n2,
                      C1, C2, bn, bx1n, bx2n,
                      vmin[n1], vmax[n1], vmin[n2], vmax[n2])
                ipair += 1
    print("jpdf done")


def _emit(outputs, base, p1, p2, n1, n2, C1, C2, b, bx1, bx2,
          v1min, v1max, v2min, v2max):
    if outputs["gnuplot"]:
        write_gnuplot(f"{base}/Pdf_{p1}_{p2}.gpd", C1, C2, b)
    if outputs["matlab"]:
        write_matlab(base, p1, p2, C1, C2, b, bx1, bx2)
    if outputs["tecplot"]:
        write_tecplot(f"{base}/Pdf_{p1}_{p2}.tpd", n1, n2, C1, C2, b)
    if outputs["fab"]:
        write_fab_pdf(f"{base}/Pdf_{p1}_{p2}.fab", C1, C2, b)
    if outputs["scatter"]:
        write_scatter(f"{base}/Scatter_{p1}_{p2}.dat", C1, C2, b)
    if outputs["plotfile"]:
        write_pdf_plotfile(f"{base}/Pdf_{p1}_{p2}_plt", n1, n2,
                           v1min, v1max, v2min, v2max, b)
