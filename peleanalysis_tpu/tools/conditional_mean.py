"""``conditionalMean`` — conditional mean/std of variables binned by another.

JAX replacement for PeleAnalysis Src/conditionalMean.cpp (406 LoC):
across a list of plotfiles, bin ``avgComps`` by ``binComp`` over
[binMin,binMax) x nBins, weighting each cell by its refinement volume
(weights[lev] = prod of ref ratios to the finest level,
conditionalMean.cpp:198-205), with fine-covered cells masked
(conditionalMean.cpp:246-258).  Output: Tecplot/gnuplot ASCII with
sum/sumSq/avg/std[/min/max]/N/p columns (conditionalMean.cpp:310-399).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..amr.dense import DenseAmrState
from ..amr.hierarchy import AmrState
from ..ops.stats import binned_stats
from ..parmparse import ParmParse
from functools import partial
import jax


@partial(jax.jit, static_argnames=("ib", "ia", "weights", "nbins",
                                   "with_minmax", "bin_min", "bin_max"))
def _accumulate_all(data_list, mask_list, ib, ia, weights, bin_min, bin_max,
                    nbins, with_minmax):
    import jax.numpy as jnp
    # Per-component moment shift = global masked mean (all levels), so the
    # float32 sumsq contraction stays cancellation-free (ops/stats.py docs).
    num = 0.0
    den = 0.0
    for lev in range(len(data_list)):
        v = data_list[lev][jnp.asarray(ia)]
        w = jnp.where(mask_list[lev], float(weights[lev]), 0.0)
        num = num + jnp.sum(w[None] * v, axis=tuple(range(1, v.ndim)))
        den = den + jnp.sum(w)
    # f32-safe zero guard (r5 review fix: 1e-300 underflows to 0.0 in
    # float32, so an empty selection made shift = 0/0 = NaN and poisoned
    # every output column — same footgun ops/solve.py documents)
    tiny = 1e-30 if jnp.result_type(den) == jnp.float32 else 1e-300
    shift = num / jnp.maximum(den, tiny)
    acc = None
    for lev in range(len(data_list)):
        out = binned_stats(data_list[lev][ib],
                           data_list[lev][jnp.asarray(ia)],
                           float(weights[lev]), mask_list[lev],
                           bin_min, bin_max, nbins, clamp=False,
                           with_minmax=with_minmax, shift=shift)
        if acc is None:
            acc = list(out)
        else:
            acc[0] = acc[0] + out[0]
            acc[1] = acc[1] + out[1]
            acc[2] = acc[2] + out[2]
            if with_minmax:
                acc[3] = jnp.minimum(acc[3], out[3])
                acc[4] = jnp.maximum(acc[4], out[4])
    return tuple(a for a in acc if a is not None) + (shift,)


def refinement_weights(ref_ratio: Sequence[int], n_levels: int,
                       ndim: int = 3) -> List[int]:
    """weights[lev] = fine-cells-per-cell at the finest level
    (conditionalMean.cpp:198-205); ndim=2 for DIM=2 plotfiles."""
    w = [1] * n_levels
    for lev in range(n_levels - 2, -1, -1):
        w[lev] = w[lev + 1] * ref_ratio[lev] ** ndim
    return w


def accumulate_conditional_mean(
    dstate: DenseAmrState,
    bin_name: str,
    avg_names: Sequence[str],
    nbins: int,
    bin_min: float,
    bin_max: float,
    with_minmax: bool = False,
    bounds=None,
):
    """All levels accumulated inside one jitted call (one host fetch).
    bounds: optional ((lox,loy,loz),(hix,hiy,hiz)) physical sub-box — cells
    outside are excluded (conditionalMean.cpp:180-192 bounds key, coarse
    indices rounded with the reference's ±1e-4*dx nudges)."""
    meta = dstate.meta
    ndim = 2 if getattr(meta, "ndim2", False) else 3
    weights = tuple(refinement_weights(meta.ref_ratio, meta.n_levels, ndim))
    ib = dstate.comp(bin_name)
    ia = tuple(dstate.comp(n) for n in avg_names)
    masks = [dstate.valid_mask(lev) for lev in range(meta.n_levels)]
    if bounds is not None:
        import jax.numpy as jnp
        g0 = meta.geoms[0]
        lo0 = [max(g0.domain.lo[d],
                   int((bounds[0][d] - g0.prob_lo[d] + 1e-4 * g0.dx[d])
                       / g0.dx[d])) for d in range(3)]
        hi0 = [min(g0.domain.hi[d],
                   int((bounds[1][d] - g0.prob_lo[d] - 1e-4 * g0.dx[d])
                       / g0.dx[d])) for d in range(3)]
        rat = 1
        for lev in range(meta.n_levels):
            if lev > 0:
                rat *= meta.ref_ratio[lev - 1]
            bbox = dstate.lmeta[lev].bbox
            sel = []
            for d in range(3):
                idx = np.arange(bbox.lo[d], bbox.hi[d] + 1)
                sel.append((idx >= lo0[d] * rat)
                           & (idx <= (hi0[d] + 1) * rat - 1))
            box_m = (sel[0][:, None, None] & sel[1][None, :, None]
                     & sel[2][None, None, :])
            masks[lev] = masks[lev] & jnp.asarray(box_m)
    out = jax.device_get(_accumulate_all(
        list(dstate.data), masks, ib, ia, weights,
        float(bin_min), float(bin_max), nbins, with_minmax))
    if with_minmax:
        hits, sums_s, sumsq_s, mins, maxs, shift = out
    else:
        hits, sums_s, sumsq_s, shift = out
        mins = np.full((nbins, len(avg_names)), np.inf)
        maxs = np.full((nbins, len(avg_names)), -np.inf)
    # Raw columns reconstructed in float64 on host (reference accumulates in
    # double); the shift terms cancel exactly in the downstream variance.
    from ..ops.stats import reconstruct_moments
    sums, sumsq = reconstruct_moments(hits, sums_s, sumsq_s, shift)
    return (np.asarray(hits, np.float64), sums, sumsq,
            np.asarray(mins, np.float64), np.asarray(maxs, np.float64))


@partial(jax.jit, static_argnames=("ib", "ia", "weights", "bin_min",
                                   "bin_max", "nbins", "i1", "i2", "vols",
                                   "pair_bounds", "pair_nbins"))
def _stats_fused_jit(data_list, mask_list, ib, ia, weights, bin_min,
                     bin_max, nbins, i1, i2, vols, pair_bounds, pair_nbins):
    """Module-level jit (closure jits retrace per call)."""
    from .jpdf import _jpdf_all
    cm = _accumulate_all(data_list, mask_list, ib, ia, weights,
                         bin_min, bin_max, nbins, False)
    f1 = [d[i1] for d in data_list]
    f2 = [d[i2] for d in data_list]
    jp = _jpdf_all(f1, f2, mask_list, vols, pair_bounds, pair_nbins)
    return cm, jp


def accumulate_stats_fused(dstate, bin_name: str, avg_names: Sequence[str],
                           nbins: int, bin_min: float, bin_max: float,
                           pair, pair_bounds, pair_nbins: int):
    """conditionalMean + one jpdf pair in ONE dispatch + ONE device fetch.

    A workflow needing both (the BASELINE config-5 composite) makes one
    dispatch and one fetch instead of two of each.  pair = (name1, name2); pair_bounds =
    (v1min, v1max, v2min, v2max).  Returns ((hits, sums, sumsq),
    (b, bx1, bx2)) with the standalone paths' float64 host reconstructions
    (identical numerics — the jitted accumulators are simply inlined into
    one program)."""
    from ..ops.stats import reconstruct_moments

    meta = dstate.meta
    ndim = 2 if getattr(meta, "ndim2", False) else 3
    weights = tuple(refinement_weights(meta.ref_ratio, meta.n_levels, ndim))
    ib = dstate.comp(bin_name)
    ia = tuple(dstate.comp(n) for n in avg_names)
    masks = [dstate.valid_mask(lev) for lev in range(meta.n_levels)]
    i1 = dstate.comp(pair[0])
    i2 = dstate.comp(pair[1])
    vols = tuple(float(np.prod(meta.geoms[lev].dx))
                 for lev in range(meta.n_levels))

    (hits, sums_s, sumsq_s, shift), (b, bx1_s, bx2_s, c1, c2) = \
        jax.device_get(_stats_fused_jit(
            list(dstate.data), masks, ib, ia, weights,
            float(bin_min), float(bin_max), nbins, i1, i2, vols,
            tuple(float(v) for v in pair_bounds), pair_nbins))
    sums, sumsq = reconstruct_moments(hits, sums_s, sumsq_s, shift)
    b64 = np.asarray(b, np.float64)
    bx1 = np.asarray(bx1_s, np.float64) + np.float64(c1) * b64
    bx2 = np.asarray(bx2_s, np.float64) + np.float64(c2) * b64
    return ((np.asarray(hits, np.float64), sums, sumsq), (b64, bx1, bx2))


def write_cm_dat(path: str, bin_name: str, avg_names: Sequence[str],
                 nbins: int, bin_min: float, bin_max: float,
                 hits, sums, sumsq, mins=None, maxs=None,
                 with_minmax: bool = False) -> None:
    """Tecplot-style ASCII matching conditionalMean.cpp:310-399."""
    with open(path, "w") as f:
        cols = ["VARIABLES = " + bin_name]
        for suf in ("sum", "sumSq", "avg", "std"):
            cols += [f"{n}_{suf}" for n in avg_names]
        if with_minmax:
            for suf in ("min", "max"):
                cols += [f"{n}_{suf}" for n in avg_names]
        f.write(" ".join(cols) + "  N  p \n")
        f.write(f"ZONE I={nbins} DATAPACKING=POINT\n")
        dv = (bin_max - bin_min) / nbins
        ntot = hits.sum()
        for i in range(nbins):
            row = [bin_min + dv * (0.5 + i)]
            row += list(sums[i])
            row += list(sumsq[i])
            if hits[i] > 0:
                row += list(sums[i] / hits[i])
                var = sumsq[i] / hits[i] - (sums[i] / hits[i]) ** 2
                row += list(np.sqrt(np.maximum(var, 0.0)))
            else:
                row += [0.0] * (2 * len(avg_names))
            if with_minmax:
                row += list(mins[i])
                row += list(maxs[i])
            row += [hits[i], hits[i] / max(ntot, 1)]
            f.write(" ".join(f"{v:e}" for v in row) + "\n")


def _resolve(name_or_idx: str, var_names: Sequence[str]) -> str:
    """The reference takes integer component indices; accept both."""
    try:
        return var_names[int(name_or_idx)]
    except ValueError:
        return name_or_idx


def main(args: dict) -> None:
    """CLI: conditionalMean infile=<plt>... binComp=<i|name> avgComps=<i|name>...
    nBins= binMin= binMax= [writeBinMinMax=0] [finestLevel=] [aja=0]
    [prefetch=1 — files of read-ahead for multi-file series (the next
    plotfile's host parse + upload overlaps this file's device work);
    prefetch=0 restores the serial loop]"""
    from ..io.plotfile import PlotfileReader

    pp = ParmParse(args)
    infiles = pp.get_str_list("infiles" if pp.contains("infiles") else "infile")
    nbins = pp.query_int("nBins", 64)
    bin_min = pp.get_float("binMin")
    bin_max = pp.get_float("binMax")
    with_minmax = pp.query_bool("writeBinMinMax", False)
    finest = pp.query_int("finestLevel", None)
    aja = pp.query_bool("aja", False)
    out_suffix = pp.query_str("outSuffix", "")
    bounds = None
    if pp.contains("bounds"):
        barr = pp.get_float_list("bounds")
        if len(barr) == 4:        # DIM=2 plotfile: promote z to the unit cell
            barr = barr[:2] + [-1.0e30] + barr[2:] + [1.0e30]
        if len(barr) != 6:
            raise ValueError("bounds expects 2*DIM reals: lo... hi...")
        bounds = (tuple(barr[:3]), tuple(barr[3:]))
        # snap to TRUE level-0 cell faces up front: the sparse clustered
        # path sees sub-states whose own "level 0" is finer, and rounding
        # there would select different cells than the dense path
        from ..io.plotfile import PlotfileReader
        meta0 = PlotfileReader(infiles[0]).meta
        g = meta0.geometry(0)
        nd = meta0.ndim
        lo0 = [max(g.domain.lo[d],
                   int((bounds[0][d] - g.prob_lo[d] + 1e-4 * g.dx[d])
                       / g.dx[d])) for d in range(nd)]
        hi0 = [min(g.domain.hi[d],
                   int((bounds[1][d] - g.prob_lo[d] - 1e-4 * g.dx[d])
                       / g.dx[d])) for d in range(nd)]
        bounds = (tuple(g.prob_lo[d] + lo0[d] * g.dx[d]
                        for d in range(nd)) + bounds[0][nd:],
                  tuple(g.prob_lo[d] + (hi0[d] + 1) * g.dx[d]
                        for d in range(nd)) + bounds[1][nd:])

    var_names = PlotfileReader(infiles[0]).var_names
    bin_name = _resolve(pp.get_str("binComp"), var_names)
    avg_names = [_resolve(s, var_names) for s in pp.get_str_list("avgComps")]

    nb = len(avg_names)
    hits = np.zeros(nbins)
    sums = np.zeros((nbins, nb))
    sumsq = np.zeros((nbins, nb))
    mins = np.full((nbins, nb), np.inf)
    maxs = np.full((nbins, nb), -np.inf)
    from ..amr.cluster import needs_clustering, sparse_stats_parts
    from ..io.prefetch import iter_states, query_prefetch
    # dtype=float64 gives the reference's double accumulation (the
    # shifted moments keep the std columns exact in f32 as well)
    dt = {"float64": np.float64, "f64": np.float64,
          "double": np.float64, "float32": np.float32,
          "f32": np.float32, "single": np.float32}[
        pp.query_str("dtype", "float32")]
    # time series: file i+1's host parse + upload rides under file i's
    # device compute + fetch (io/prefetch.py; prefetch=0 restores serial)
    for plt, st in iter_states(args, infiles, names=[bin_name] + avg_names,
                               max_level=finest, dtype=dt,
                               depth=query_prefetch(pp)):
        if (st.meta.n_levels > 1 and needs_clustering(st.meta.bas[-1])
                and not pp.query_bool("force_dense", False)):
            # sparse refinement: accumulate coarse levels once (global
            # covered mask) + the finest level per dense cluster; weights
            # count finest-equivalent cells, so the trimmed coarse part
            # rescales by ratio^ndim (amr/cluster.sparse_stats_parts)
            print("conditionalMean: sparse refinement -> clustered path")
            ndim = 2 if st.meta.ndim2 else 3
            ds_c, clusters, r = sparse_stats_parts(st)
            parts = [(ds_c, float(r ** ndim))] \
                + [(c, 1.0) for c in clusters]
        else:
            from ..session import dense_state
            parts = [(dense_state(args, st), 1.0)]
        for ds, scale in parts:
            h, s, s2, mn, mx = accumulate_conditional_mean(
                ds, bin_name, avg_names, nbins, bin_min, bin_max,
                with_minmax, bounds=bounds)
            hits += scale * h
            sums += scale * s
            sumsq += scale * s2
            mins = np.minimum(mins, mn)
            maxs = np.maximum(maxs, mx)

    out = (infiles[0] + f"/CM_{bin_name}{out_suffix}.dat" if aja
           else f"CM_{bin_name}{out_suffix}.dat")
    out = pp.query_str("outfile", out)
    write_cm_dat(out, bin_name, avg_names, nbins, bin_min, bin_max,
                 hits, sums, sumsq, mins, maxs, with_minmax)
    print(f"wrote {out}")
