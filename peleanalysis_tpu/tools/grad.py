"""``grad`` — gradient + magnitude of a scalar on all AMR levels.

JAX replacement for PeleAnalysis Src/grad.cpp (261 LoC): reads a
plotfile variable (default ``temp``), computes the cell-centered gradient and
its magnitude on every level, and writes a plotfile with components
``[gradVar, aux..., <var>_gx, <var>_gy, <var>_gz, ||grad<var>||]``
(naming per grad.cpp:243-250).

Where the reference builds a composite MLPoisson and extracts MLMG face
fluxes (grad.cpp:172-219), we FillPatch one ghost ring (linear coarse-fine
interp) and apply a fused centered-difference + magnitude kernel per level —
see peleanalysis_tpu/ops/stencil.py for the equivalence argument.
BCs: periodic where ``is_per``; first-order extrap otherwise
(grad.cpp:136-144); ``sym_dir`` selects an even reflection.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..amr.hierarchy import AmrState
from ..ops.fill import FOEXTRAP, REFLECT_EVEN, FillPlan, apply_fill, get_fill_plan
from ..ops.stencil import centered_gradient, magnitude


# cross-instance jitted-pipeline cache (see amr/dense.py shared_engine)
_GLOBAL_GRAD_FNS = {}


def grad_bc(is_per: Sequence[bool], sym_dir: Optional[Sequence[int]] = None):
    ndim = len(is_per)
    bc = []
    for d in range(ndim):
        mode = REFLECT_EVEN if (sym_dir and sym_dir[d]) else FOEXTRAP
        bc.append((mode, mode))
    return tuple(bc)


@partial(jax.jit, static_argnames=("dx",))
def _grad_level(plan: FillPlan, data: jnp.ndarray, crse, dx) -> jnp.ndarray:
    """One level: fill 1 ghost -> grad + |grad|. data: [nbox,1,*P] ->
    [nbox,4,*P]."""
    grown = apply_fill(plan, data, crse)
    gx, gy, gz = centered_gradient(grown, dx, shrink=1)
    mag = magnitude(gx, gy, gz)
    return jnp.concatenate([gx, gy, gz, mag], axis=1)


def compute_grad_dense(dstate, var: str,
                       aux: Sequence[str] = (),
                       sym_dir: Optional[Sequence[int]] = None,
                       interp: str = "linear",
                       flux_match: bool = False):
    """Dense fast path: ghost fill + gradient as one fused slicing pipeline
    per level (see amr/dense.py for the layout rationale)."""
    import jax

    from ..ops.dense_fill import fill_dense_multilevel

    meta = dstate.meta
    lmeta = dstate.lmeta     # closure must NOT capture dstate itself: the
    #                          cross-instance cache would pin the whole
    #                          instance (its device data) alive
    bc = grad_bc([False] * meta.ndim, sym_dir)
    ic = dstate.comp(var)
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]

    # covered masks stay closure-captured as HOST numpy: the flux plan is
    # host-derived (cannot trace), and numpy capture means the global
    # engine cache pins host RAM, never HBM
    covered = ([np.asarray(dstate.covered_mask(l))
                for l in range(meta.n_levels)] if flux_match else None)

    def all_levels(data_list, mask_list):
        grown = fill_dense_multilevel(meta, lmeta, data_list,
                                      mask_list, 1, bc, interp)
        outs = []
        if flux_match:
            # MLMG-style: c-f interface faces take the restricted fine flux
            # (grad.cpp:178-219 composite apply + getFluxes)
            from ..ops.restrict import flux_matched_gradient
            gall = flux_matched_gradient(meta, lmeta, grown,
                                         covered)
            for lev in range(meta.n_levels):
                gx, gy, gz = gall[lev]
                outs.append(jnp.concatenate(
                    [gx, gy, gz, magnitude(gx, gy, gz)], axis=0))
            return outs
        for lev, g in enumerate(grown):
            gx, gy, gz = centered_gradient(g, meta.geoms[lev].dx, 1)
            outs.append(jnp.concatenate(
                [gx, gy, gz, magnitude(gx, gy, gz)], axis=0))
        return outs

    # cache the jitted pipeline ON the state AND across instances with the
    # same hierarchy (a closure jit re-traces per call; a fresh state per
    # time-series plotfile would re-trace per run)
    from ..amr.dense import shared_engine
    cache = getattr(dstate, "_tool_fn_cache", None)
    if cache is None:
        cache = dstate._tool_fn_cache = {}
    key = ("grad", bc, interp, flux_match)
    if key not in cache:
        cache[key] = shared_engine(_GLOBAL_GRAD_FNS, 32, dstate, key,
                                   lambda: jax.jit(all_levels))
    scalars = [d[ic : ic + 1] for d in dstate.data]
    gcomps = cache[key](scalars, masks)
    out_levels = []
    for lev in range(meta.n_levels):
        passthrough = [dstate.data[lev][dstate.comp(n) : dstate.comp(n) + 1]
                       for n in (var,) + tuple(aux)]
        out_levels.append(jnp.concatenate(passthrough + [gcomps[lev]],
                                          axis=0))
    names = [var, *aux,
             f"{var}_gx", f"{var}_gy", f"{var}_gz", f"||grad{var}||"]
    return dstate.with_data(names, out_levels)


def compute_grad(state: AmrState, var: str,
                 aux: Sequence[str] = (),
                 sym_dir: Optional[Sequence[int]] = None,
                 interp: str = "linear") -> AmrState:
    meta = state.meta
    bc = grad_bc([False] * meta.ndim, sym_dir)  # periodicity from geometry
    ic = state.comp(var)
    out_levels = []
    for lev in range(meta.n_levels):
        ba = meta.bas[lev]
        geom = meta.geoms[lev]
        if lev > 0:
            ba_c, pshape_c = meta.bas[lev - 1], meta.pad_shape(lev - 1)
            ratio = meta.ref_ratio[lev - 1]
            crse = state.data[lev - 1][:, ic : ic + 1]
        else:
            ba_c = pshape_c = crse = None
            ratio = 2
        plan = get_fill_plan(ba, geom, 1, meta.pad_shape(lev), ba_c, pshape_c,
                             ratio, bc, interp)
        gcomp = _grad_level(plan, state.data[lev][:, ic : ic + 1], crse,
                            geom.dx)
        passthrough = [state.data[lev][:, state.comp(n) : state.comp(n) + 1]
                       for n in (var,) + tuple(aux)]
        out_levels.append(jnp.concatenate(passthrough + [gcomp], axis=1))
    names = [var, *aux,
             f"{var}_gx", f"{var}_gy", f"{var}_gz", f"||grad{var}||"]
    return state.with_data(names, out_levels)


def _grad_clusters_batched(subs, infos, var, sym_dir, interp, ndev,
                           aux=()):
    """Cluster-axis SPMD grad: every canonical cluster's 4-comp gradient in
    ONE vmapped dispatch per bucket, the batch axis sharded over an
    ``ndev``-device mesh (parallel/cluster_shard.py — the reference's
    DistributionMapping analog, grad.cpp:160-163).  Returns per-cluster
    output states (global-frame) for canonical entries, None for legacy."""
    from ..amr.canonical import global_frame
    from ..ops.dense_fill import fill_dense_multilevel
    from ..parallel.cluster_shard import cluster_mesh, run_clusters_batched

    mesh = cluster_mesh(ndev) if ndev > 1 else None
    bc = grad_bc([False] * subs[0].meta.ndim, sym_dir)

    def core_builder(tpl):
        meta, lmeta = tpl.meta, tpl.lmeta

        def one(data_list, mask_list):
            grown = fill_dense_multilevel(meta, lmeta, data_list,
                                          mask_list, 1, bc, interp)
            outs = []
            for lev, g in enumerate(grown):
                gx, gy, gz = centered_gradient(g, meta.geoms[lev].dx, 1)
                outs.append(jnp.concatenate(
                    [gx, gy, gz, magnitude(gx, gy, gz)], axis=0))
            return outs

        return one

    names = [var, *aux,
             f"{var}_gx", f"{var}_gy", f"{var}_gz", f"||grad{var}||"]
    raw = run_clusters_batched(
        subs, infos, ("grad", bc, interp), core_builder, mesh,
        inputs_select=lambda s: (
            [s.data[lev][s.comp(var): s.comp(var) + 1]
             for lev in range(s.meta.n_levels)],
            [s.in_level_mask(lev) for lev in range(s.meta.n_levels)]))
    outs = [None] * len(subs)
    for i, g in enumerate(raw):
        if g is None:
            continue
        sub = subs[i]
        out_levels = [
            jnp.concatenate(
                [sub.data[lev][sub.comp(n): sub.comp(n) + 1]
                 for n in (var,) + tuple(aux)] + [g[lev]], axis=0)
            for lev in range(sub.meta.n_levels)]
        outs[i] = global_frame(sub.with_data(names, out_levels), infos[i])
    return outs


def main(args: dict) -> None:
    """CLI driver: grad infile=<plt> [gradVar=temp] [outfile=...]
    [Aux_Variables=...] [is_per=1 1 1] [sym_dir=0 0 0]
    [ndevices=N  (dense: spatial mesh; sparse: cluster-axis SPMD)]
    [cluster_batch=0|1  (sparse: batch canonical clusters into one
    vmapped dispatch even on one device; default 1 iff ndevices>1)]."""
    from ..parmparse import ParmParse

    pp = ParmParse(args)
    infile = pp.get_str("infile")
    var = pp.query_str("gradVar", "temp")
    aux = pp.query_str_list("Aux_Variables", [])
    is_per = pp.query_int_list("is_per", [1, 1, 1])
    sym_dir = pp.query_int_list("sym_dir", [0, 0, 0])
    outfile = pp.query_str("outfile", infile + "_gt")
    finest = pp.query_int("finestLevel", None)

    from ..amr.cluster import needs_clustering
    from ..amr.dense import DenseAmrState
    from ..session import dense_state, get_session, load_state, stage_write_plotfile

    state = load_state(
        args, infile, names=[var] + list(aux), max_level=finest,
        is_periodic=[bool(p) for p in is_per])
    force_dense = pp.query_bool("force_dense", False)
    # n_levels > 1: the clustered path splits the FINEST level over a real
    # coarse level; a single-level hierarchy has no coarse pass to pair it
    # with (and level 0 must tile the domain for fills anyway) — same gate
    # as curvature/isosurface
    sparse = (not force_dense and state.meta.n_levels > 1
              and any(needs_clustering(state.meta.bas[l])
                      for l in range(state.meta.n_levels)))
    if sparse and pp.query_bool("fluxMatch", False):
        # the clustered path does not implement flux matching: fall back to
        # dense (more HBM) rather than silently dropping the request
        print("grad: fluxMatch forces the dense path on this "
              "sparse-refinement plotfile (higher HBM footprint)")
        sparse = False
    groups = subs = base = infos = None
    if sparse:
        from ..amr.canonical import canonical_cluster_substates
        groups, subs, base, infos = canonical_cluster_substates(
            state, ngrow_max=1, interp_stencil=1)
        if (pp.query_int("ndevices", 1) > 1
                and not any(i.canonical for i in infos)):
            # every cluster is boundary-adjacent (legacy frame): the
            # cluster-axis SPMD cannot run, so honor ndevices via the
            # dense spatial mesh instead of silently dropping the request
            print("grad: no canonical clusters (boundary-adjacent) — "
                  "ndevices honored via the dense path (higher HBM "
                  "footprint)")
            sparse = False
    if sparse:
        # sparse refinement: per-cluster dense patches (footprint ~ cluster
        # bboxes; 1-ghost fills + cluster separation make it exact, and the
        # quadratic c-f interpolation works unlike the gather-plan path —
        # the reference gets this scaling from per-rank ownership,
        # grad.cpp:160-163)
        from ..amr.canonical import coarse_only_state, global_frame
        print("grad: sparse refinement detected -> clustered path")
        interp = pp.query_str("cf_interp", "quadratic")
        # canonical frames: equal-bucket clusters share ONE compiled engine
        # (amr/canonical.py); coarse-level outputs come from a single global
        # coarse pass (fills never read finer levels, so coarse gradients
        # are identical to the full run's)
        coarse_out = compute_grad_dense(coarse_only_state(state, base),
                                        var, aux=tuple(aux),
                                        sym_dir=sym_dir, interp=interp)
        ndev = pp.query_int("ndevices", 1)
        # cluster-axis SPMD (parallel/cluster_shard.py): canonical clusters
        # stack on a batch axis sharded over the mesh — the reference's
        # box->rank DistributionMapping (grad.cpp:160-163).  Default on for
        # ndevices>1; cluster_batch=1 opts in single-device batching (K
        # dispatches -> 1)
        batch = pp.query_bool("cluster_batch", ndev > 1)
        outs_b = [None] * len(subs)
        if batch and any(i.canonical for i in infos):
            outs_b = _grad_clusters_batched(subs, infos, var, sym_dir,
                                            interp, ndev, aux=tuple(aux))
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(len(subs), 8)) as ex:
            outs = list(ex.map(
                lambda si: outs_b[si] if outs_b[si] is not None
                else global_frame(
                    compute_grad_dense(subs[si], var, aux=tuple(aux),
                                       sym_dir=sym_dir, interp=interp),
                    infos[si]), range(len(subs))))
        from ..io.plotfile import write_plotfile
        meta = state.meta
        fin = meta.n_levels - 1

        def box_fab(src, lev, b):
            bbox = src.lmeta[lev].bbox
            sl = tuple(slice(b.lo[d] - bbox.lo[d], b.hi[d] - bbox.lo[d] + 1)
                       for d in range(3))
            return np.asarray(src.data[lev][(slice(None),) + sl])

        level_data = [[box_fab(coarse_out, lev, b) for b in meta.bas[lev]]
                      for lev in range(fin)]
        boxes = list(meta.bas[fin])
        fine_fabs = [None] * len(boxes)
        for gi, g in enumerate(groups):
            for i in g:
                fine_fabs[i] = box_fab(outs[gi], fin, boxes[i])
        level_data.append(fine_fabs)
        # shared writer tail: demotes DIM=2 states back to 2-D plotfiles
        from ..amr.hierarchy import write_level_fabs
        write_level_fabs(meta, list(coarse_out.names), level_data, outfile)
        n_can = sum(1 for i in infos if i.canonical)
        print(f"wrote {outfile} ({len(groups)} clusters, "
              f"{n_can} canonical-frame)")
        return
    dstate = dense_state(args, state)
    ndev = pp.query_int("ndevices", 1)
    if ndev > 1:
        # spatial SPMD over a device mesh (DistributionMapping analog,
        # grad.cpp:160-163); non-divisible levels are padded
        from ..parallel.dense_shard import (mesh_from_pp,
                                            shard_dense_state)
        dstate = shard_dense_state(dstate, mesh_from_pp(pp, ndev))
    out = compute_grad_dense(
        dstate, var, aux=tuple(aux), sym_dir=sym_dir,
        interp=pp.query_str("cf_interp", "quadratic"),
        flux_match=pp.query_bool("fluxMatch", False))
    sess = get_session(args)
    if sess is not None:
        sess.put_plotfile(outfile, out)
    if stage_write_plotfile(args, out, outfile):
        print(f"wrote {outfile}")
