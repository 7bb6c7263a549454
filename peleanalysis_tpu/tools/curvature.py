"""``curvature`` — mean/Gaussian curvature, flame normal, strain of a
progress-variable field.

JAX replacement for PeleAnalysis Src/curvature.cpp (849 LoC).
Semantics reproduced (with formula citations):

  * progress var c = (s - progMin)/(progMax - progMin), min/max scanned from
    the file unless given (curvature.cpp:137-158, 308-321)
  * optional implicit smoothing (I - beta ∇²) c~ = c (curvature.cpp:328-406);
    here per-level matrix-free CG, coarse->fine with c-f values pinned
  * G = ∇c~ (2nd-order centered on filled ghosts — see ops/stencil.py for the
    MLMG-flux equivalence note); normgrad = -max(1e-14,|G|)
    (curvature.cpp:465-484)
  * flame normal N = G / normgrad = -G/|G|, "toward fresh gases"
    (curvature.cpp:487-501)
  * MeanCurvature = 0.5 * div(N) in 3D (curvature.cpp:508-546), each dN_i/dx_i
    taken with the same derived-field fill the reference gets from per-level
    MLPoisson with coarse-fine BC = coarse N (curvature.cpp:517-524)
  * GaussianCurvature = (G . adj(H) . G)/normgrad^4 where H_ij = d G_i/dx_j
    computed as gradient-of-gradient (matching the reference's two-pass
    discretization, curvature.cpp:578-673); evaluated as
    (N . adj(H) . N)/normgrad^2 so the floor stays finite in float32
  * StrainRate = -NN:∇u + ∇·u.  NOTE the reference's second assignment at
    curvature.cpp:745 overwrites the first, so its output is actually just
    ∇·u; we compute the documented formula by default and provide
    replicate_strain_bug=True for bit-parity (SURVEY.md §2.1 note).
  * optional strain tensor ROST_dU[xyz]d[xyz] and VelFlameNormal = u·N
    (curvature.cpp:754-789)
  * thresholding: Km, N, Kg, VelFlameNormal zeroed where c < threshold or
    c > 1-threshold (curvature.cpp:560-567)

Output component names match curvature.cpp:796-829.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..amr.dense import DenseAmrState
from ..ops.dense_fill import fill_dense_arrays, fill_dense_multilevel
from ..ops.restrict import average_down_all
from ..ops.solve import cg_solve, cg_solve_composite
from ..ops.stencil import centered_gradient, interior
from .grad import grad_bc

D = 3


# cross-instance jitted-pipeline cache (see amr/dense.py shared_engine)
_GLOBAL_CURV_FNS = {}


@jax.jit
def _masked_minmax(vs, ms):
    """Global masked (min, max) over a list of (value, mask) level arrays in
    ONE dispatch + ONE fetch, instead of a per-level float(jnp.min/max)
    fetch per scalar.  Module-level jit: closure jits retrace per call."""
    los = [jnp.min(jnp.where(m, v, np.inf)) for v, m in zip(vs, ms)]
    his = [jnp.max(jnp.where(m, v, -np.inf)) for v, m in zip(vs, ms)]
    return jnp.stack([jnp.min(jnp.stack(los)), jnp.max(jnp.stack(his))])


def _file_minmax(pairs):
    lo_hi = np.asarray(_masked_minmax([p[0] for p in pairs],
                                      [p[1] for p in pairs]))
    return float(lo_hi[0]), float(lo_hi[1])


def _grad_multilevel(meta, lmeta, field_list, mask_list, bc, interp):
    """Per-level gradients of a multi-level scalar field, each level's ghosts
    filled from the coarser level of the SAME derived field (the reference's
    setCoarseFineBC pattern).  One bottom-up fill pass for all levels."""
    grown = fill_dense_multilevel(meta, lmeta, field_list, mask_list, 1,
                                  bc, interp)
    return [centered_gradient(g, meta.geoms[lev].dx, 1)
            for lev, g in enumerate(grown)]  # [lev][dim] -> [1, *bbox]


def _make_pipeline(meta, lmeta, ic, iv, bc, interp, do_smooth,
                   smooth_composite, smooth_time, smooth_iters,
                   smooth_rtol, do_gauss, do_strain, get_strain_tensor,
                   do_velnormal, do_threshold, threshold,
                   replicate_strain_bug):
    """The full curvature derived-field chain as a PURE function of
    traced per-level inputs (closes over meta/lmeta/flags only, never
    device data) — shared by the dense tool, the serial clustered path
    and the cluster-axis SPMD batch (parallel/cluster_shard.py)."""
    need_vel = do_strain or do_velnormal

    def pipeline(data_list, mask_list, pmin, pmax, valid_masks,
                 covered_masks):
        scal = [d[ic : ic + 1] for d in data_list]
        inv = 1.0 / (pmax - pmin)
        prog = [jnp.asarray((s - pmin) * inv, s.dtype) for s in scal]

        # -- smoothing solve ---------------------------------------------------
        from ..ops.stencil import laplacian

        if do_smooth and smooth_composite:
            # composite solve over all levels at once (the MLMG analog):
            # covered coarse cells track the fine solution via average_down,
            # ghosts couple fine to coarse via the fill — both directions
            # inside the operator
            valid = valid_masks
            covered = covered_masks
            vols = [meta.geoms[l].cell_volume()
                    for l in range(meta.n_levels)]

            def apply_A(x_list):
                xd = average_down_all(meta, lmeta, x_list, covered)
                grown = fill_dense_multilevel(meta, lmeta, xd, mask_list,
                                              1, bc, interp)
                return [xd[l] - smooth_time
                        * laplacian(grown[l], meta.geoms[l].dx, 1)
                        for l in range(meta.n_levels)]

            smoothed = cg_solve_composite(apply_A, prog, prog, valid, vols,
                                          smooth_iters, rtol=smooth_rtol)
            smoothed = average_down_all(meta, lmeta, smoothed, covered)
        elif do_smooth:
            smoothed: List[jnp.ndarray] = list(prog)
            for lev in range(meta.n_levels):
                dx = meta.geoms[lev].dx

                def apply_A(x, lev=lev):
                    flds = smoothed[:lev] + [x] + prog[lev + 1:]
                    grown = fill_dense_arrays(meta, lmeta, flds, mask_list,
                                              lev, 1, bc, interp)
                    return x - smooth_time * laplacian(grown, dx, 1)

                m = mask_list[lev][None]
                smoothed[lev] = cg_solve(apply_A, prog[lev], prog[lev], m,
                                         smooth_iters, rtol=smooth_rtol)
        else:
            smoothed = prog

        # -- gradient of smoothed progress -----------------------------------
        g = _grad_multilevel(meta, lmeta, smoothed, mask_list, bc, interp)
        G = [jnp.concatenate(g[lev], axis=0) for lev in range(meta.n_levels)]
        normg = [-jnp.maximum(1e-14, jnp.sqrt(jnp.sum(G[lev] ** 2, axis=0,
                                                      keepdims=True)))
                 for lev in range(meta.n_levels)]
        N = [G[lev] / normg[lev] for lev in range(meta.n_levels)]

        # -- mean curvature: 0.5 * div(N) -------------------------------------
        # per-component fills, not channel-batched [3,...] fills: XLA fuses
        # each narrow fill+gradient into its consumer, while the batch
        # materializes.  Don't re-batch without measuring on the GPU.
        gN = []
        for d in range(D):
            comp = [N[l][d : d + 1] for l in range(meta.n_levels)]
            gN.append(_grad_multilevel(meta, lmeta, comp, mask_list, bc,
                                       interp))
        Km = [0.5 * sum(gN[d][lev][d] for d in range(D))
              for lev in range(meta.n_levels)]

        # -- Gaussian curvature ------------------------------------------------
        Kg = []
        if do_gauss:
            gG = []
            for i in range(D):
                comp = [G[l][i : i + 1] for l in range(meta.n_levels)]
                gG.append(_grad_multilevel(meta, lmeta, comp, mask_list, bc,
                                           interp))
            for lev in range(meta.n_levels):
                H = [[gG[i][lev][j][0] for j in range(D)] for i in range(D)]
                adj = [[H[(i + 1) % 3][(j + 1) % 3] * H[(i + 2) % 3][(j + 2) % 3]
                        - H[(i + 1) % 3][(j + 2) % 3] * H[(i + 2) % 3][(j + 1) % 3]
                        for j in range(D)] for i in range(D)]
                # (G.adj.G)/normg^4 taken as (N.adj.N)/normg^2: the floored
                # normg^4 (1e-56) underflows to 0 in float32 and turns flat
                # cells into 0/0, while normg^2 >= 1e-28 stays a normal
                # float32 and N = 0 there, so flat cells give 0 as in float64
                Nl = N[lev]
                num = 0.0
                for i in range(D):
                    for j in range(D):
                        # adj as built above is the adjugate transpose of H;
                        # H is symmetric to truncation error so adj ~ adj^T
                        num = num + Nl[i] * adj[i][j] * Nl[j]
                Kg.append((num / normg[lev][0] ** 2)[None])

        # -- strain ------------------------------------------------------------
        SR, ROST, VN = [], [], []
        if need_vel:
            vel = [jnp.stack([d[k] for k in iv], axis=0) for d in data_list]
            if len(iv) == 2:  # planar: zero z component
                vel = [jnp.concatenate([v, jnp.zeros_like(v[:1])], axis=0)
                       for v in vel]
        if do_strain:
            gU = []
            for i in range(D):
                comp = [vel[l][i : i + 1] for l in range(meta.n_levels)]
                gU.append(_grad_multilevel(meta, lmeta, comp, mask_list, bc,
                                           interp))
            for lev in range(meta.n_levels):
                gradU = [[gU[i][lev][j][0] for j in range(D)]
                         for i in range(D)]
                divu = gradU[0][0] + gradU[1][1] + gradU[2][2]
                if replicate_strain_bug:
                    sr = divu  # reference's overwrite at curvature.cpp:745
                else:
                    nn = 0.0
                    for i in range(D):
                        for j in range(D):
                            nn = nn + gradU[i][j] * N[lev][i] * N[lev][j]
                    sr = -nn + divu
                SR.append(sr[None])
                if get_strain_tensor:
                    ROST.append(jnp.stack(
                        [gradU[i][j] for i in range(D) for j in range(D)],
                        axis=0))
        if do_velnormal:
            for lev in range(meta.n_levels):
                VN.append(jnp.sum(vel[lev] * N[lev], axis=0,
                                  keepdims=True))

        # -- thresholding ------------------------------------------------------
        outs = []
        for lev in range(meta.n_levels):
            if do_threshold:
                bad = ((prog[lev] < threshold)
                       | (prog[lev] > 1.0 - threshold))
                Km[lev] = jnp.where(bad, 0.0, Km[lev])
                Nl = jnp.where(bad, 0.0, N[lev])
                if do_gauss:
                    Kg[lev] = jnp.where(bad, 0.0, Kg[lev])
                if do_velnormal:
                    VN[lev] = jnp.where(bad, 0.0, VN[lev])
            else:
                Nl = N[lev]
            comps = [data_list[lev][ic : ic + 1]]
            if need_vel:
                comps.append(vel[lev])
            comps += [prog[lev], smoothed[lev], Km[lev], Nl]
            if do_gauss:
                comps.append(Kg[lev])
            if do_strain:
                comps.append(SR[lev])
            if get_strain_tensor:
                comps.append(ROST[lev])
            if do_velnormal:
                comps.append(VN[lev])
            outs.append(jnp.concatenate(comps, axis=0))
        return outs

    return pipeline


def compute_curvature_dense(
    dstate: DenseAmrState,
    progress_name: str = "temp",
    prog_min: Optional[float] = None,
    prog_max: Optional[float] = None,
    do_smooth: bool = False,
    smooth_time: float = 1.0e-7,
    smooth_iters: int = 50,
    smooth_rtol: Optional[float] = 1.0e-10,
    smooth_composite: bool = True,
    do_gauss: bool = True,
    do_strain: bool = False,
    get_strain_tensor: bool = False,
    do_velnormal: bool = False,
    do_threshold: bool = False,
    threshold: float = 1.0e-4,
    use_file_minmax: bool = True,
    replicate_strain_bug: bool = False,
    sym_dir: Optional[Sequence[int]] = None,
    interp: str = "linear",
) -> DenseAmrState:
    meta = dstate.meta
    lmeta = dstate.lmeta
    bc = grad_bc([False] * D, sym_dir)
    ic = dstate.comp(progress_name)
    need_vel = do_strain or do_velnormal
    # DIM=2 plotfiles carry no z_velocity: planar flow, zero-z promotion
    vel_names = [n for n in ("x_velocity", "y_velocity", "z_velocity")
                 if n in dstate.names]
    if need_vel and len(vel_names) < 2:
        raise ValueError("do_strain/do_velnormal need velocity components "
                         f"(x/y/z_velocity); plotfile has {dstate.names}")
    iv = [dstate.comp(n) for n in vel_names] if need_vel else None
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]
    # passed as jit ARGUMENTS (not closure-captured): the cross-instance
    # engine cache must never pin an instance's device masks in HBM
    valid_masks_in = [jnp.asarray(dstate.valid_mask(l))[None]
                      for l in range(meta.n_levels)]
    covered_masks_in = [dstate.covered_mask(l)
                        for l in range(meta.n_levels)]

    # progress min/max scan over valid (uncovered, in-box) cells.  With
    # use_file_minmax (the reference default, curvature.cpp:139-148) the file
    # is ALWAYS scanned and user-supplied bounds only widen the range:
    # progMin = min(user, file), progMax = max(user, file).
    if not use_file_minmax and (prog_min is None or prog_max is None):
        raise ValueError("use_file_minmax=False requires prog_min/prog_max")
    if use_file_minmax or prog_min is None or prog_max is None:
        lo, hi = _file_minmax([(dstate.data[lev][ic], dstate.valid_mask(lev))
                               for lev in range(meta.n_levels)])
        prog_min = lo if prog_min is None else min(prog_min, lo)
        prog_max = hi if prog_max is None else max(prog_max, hi)
    if prog_min >= prog_max:
        raise ValueError("progMin must be less than progMax")

    pipeline = _make_pipeline(
        meta, lmeta, ic, iv, bc, interp, do_smooth, smooth_composite,
        smooth_time, smooth_iters, smooth_rtol, do_gauss, do_strain,
        get_strain_tensor, do_velnormal, do_threshold, threshold,
        replicate_strain_bug)

    # jitted pipeline cached ON the state (closure jits retrace per call);
    # progress bounds
    # enter as traced scalars so a new file scan doesn't retrace
    from ..amr.dense import shared_engine
    cache = getattr(dstate, "_tool_fn_cache", None)
    if cache is None:
        cache = dstate._tool_fn_cache = {}
    key = ("curvature", ic, tuple(iv) if iv else None, bc, interp,
           do_smooth, smooth_composite, smooth_iters, smooth_rtol,
           smooth_time, do_gauss, do_strain, get_strain_tensor,
           do_velnormal, do_threshold, threshold, replicate_strain_bug)
    if key not in cache:
        cache[key] = shared_engine(_GLOBAL_CURV_FNS, 32, dstate, key,
                                   lambda: jax.jit(pipeline))
    dt0 = dstate.data[0].dtype
    out_levels = cache[key](list(dstate.data), masks,
                            jnp.asarray(prog_min, dt0),
                            jnp.asarray(prog_max, dt0),
                            valid_masks_in, covered_masks_in)

    names = _output_names(progress_name, vel_names, need_vel, do_gauss,
                          do_strain, get_strain_tensor, do_velnormal)
    return dstate.with_data(names, out_levels)


def _output_names(progress_name, vel_names, need_vel, do_gauss, do_strain,
                  get_strain_tensor, do_velnormal):
    """Output component order of the curvature chain (curvature.cpp:796-829)
    — single source for the dense tool and the batched cluster path."""
    names = [progress_name]
    if need_vel:
        names += vel_names
    names += ["Progress", "SmoothedProgress",
              f"MeanCurvature_{progress_name}",
              f"FlameNormalX_{progress_name}",
              f"FlameNormalY_{progress_name}",
              f"FlameNormalZ_{progress_name}"]
    if do_gauss:
        names.append(f"GaussianCurvature_{progress_name}")
    if do_strain:
        names.append(f"StrainRate_{progress_name}")
    if get_strain_tensor:
        names += [f"ROST_dU{m}d{n}" for m in "xyz" for n in "xyz"]
    if do_velnormal:
        names.append("VelFlameNormal")
    return names


def _curvature_clusters_batched(subs, infos, progress_name, do_strain,
                                do_velnormal, kw, ndev):
    """Cluster-axis SPMD curvature: the full (non-smoothed) chain for every
    canonical cluster in ONE vmapped dispatch per bucket, the batch axis
    sharded over an ``ndev``-device mesh (parallel/cluster_shard.py — the
    reference's DistributionMapping analog, curvature.cpp MFIter loops).
    Returns per-cluster global-frame output states; None for legacy
    (boundary) clusters, which the caller runs serially."""
    from ..amr.canonical import global_frame
    from ..parallel.cluster_shard import cluster_mesh, run_clusters_batched

    tpl0 = next((s for s, i in zip(subs, infos) if i.canonical), None)
    if tpl0 is None:
        return [None] * len(subs)
    if kw["do_smooth"]:
        # a vmapped rtol-stopped CG keeps iterating converged clusters
        # until the slowest one finishes (lax.while_loop under vmap), so
        # batched smoothing would silently differ from the serial path —
        # the CLI never routes do_smooth here; library callers fall back
        return [None] * len(subs)
    mesh = cluster_mesh(ndev) if ndev > 1 else None
    bc = grad_bc([False] * D, kw["sym_dir"])
    ic = tpl0.comp(progress_name)
    need_vel = do_strain or do_velnormal
    vel_names = [n for n in ("x_velocity", "y_velocity", "z_velocity")
                 if n in tpl0.names]
    iv = [tpl0.comp(n) for n in vel_names] if need_vel else None
    interp = kw["interp"]

    def core_builder(tpl):
        pipe = _make_pipeline(
            tpl.meta, tpl.lmeta, ic, iv, bc, interp, kw["do_smooth"],
            kw["smooth_composite"], kw["smooth_time"], kw["smooth_iters"],
            kw["smooth_rtol"], kw["do_gauss"], do_strain,
            kw["get_strain_tensor"], do_velnormal, kw["do_threshold"],
            kw["threshold"], kw["replicate_strain_bug"])

        def core(data_list, mask_list, pmin, pmax):
            # valid/covered masks feed only the smoothing solve, which the
            # do_smooth guard above excludes — don't stack/ship K copies
            # of masks the traced graph never reads
            return pipe(data_list, mask_list, pmin, pmax, None, None)

        return core

    def inputs_select(s):
        L = s.meta.n_levels
        return (list(s.data),
                [s.in_level_mask(l) for l in range(L)])

    dt0 = tpl0.data[0].dtype
    key = ("curvature", ic, tuple(iv) if iv else None, bc, interp,
           kw["do_smooth"], kw["smooth_composite"], kw["smooth_iters"],
           kw["smooth_rtol"], kw["smooth_time"], kw["do_gauss"], do_strain,
           kw["get_strain_tensor"], do_velnormal, kw["do_threshold"],
           kw["threshold"], kw["replicate_strain_bug"])
    raw = run_clusters_batched(
        subs, infos, key, core_builder, mesh, inputs_select,
        extra_args=(jnp.asarray(kw["prog_min"], dt0),
                    jnp.asarray(kw["prog_max"], dt0)))
    names = _output_names(progress_name, vel_names, need_vel,
                          kw["do_gauss"], do_strain,
                          kw["get_strain_tensor"], do_velnormal)
    outs = [None] * len(subs)
    for i, g in enumerate(raw):
        if g is not None:
            outs[i] = global_frame(subs[i].with_data(names, g), infos[i])
    return outs


def main(args: dict) -> None:
    """CLI: curvature infile=<plt> [progressName=temp] [progMin= progMax=]
    [do_smooth=0] [smoothing_time=1e-7] [smooth_composite=1] [smooth_iters=50]
    [smooth_rtol=1e-10  (0 disables the residual stop: fixed smooth_iters)]
    [do_gaussCurv=1] [do_strain=0] [useFileMinMax=1]
    [getStrainTensor=0] [do_velnormal=0] [threshold_prog=0] [threshold=1e-4]
    [is_per=...] [outfile=...]
    [ndevices=N  (dense: spatial mesh; sparse: cluster-axis SPMD)]
    [cluster_batch=0|1  (sparse: batch canonical clusters into one
    vmapped dispatch even on one device; default 1 iff ndevices>1)]"""
    from ..amr.hierarchy import AmrState
    from ..parmparse import ParmParse

    pp = ParmParse(args)
    infile = pp.get_str("infile")
    progress_name = pp.query_str("progressName", "temp")
    do_strain = pp.query_bool("do_strain", False)
    do_velnormal = pp.query_bool("do_velnormal", False)
    is_per = pp.query_int_list("is_per", [0, 0, 0])
    names = [progress_name]
    if do_strain or do_velnormal:
        from ..io.plotfile import PlotfileReader
        names += [n for n in ("x_velocity", "y_velocity", "z_velocity")
                  if n in PlotfileReader(infile).var_names]
    # Aux_Variables: extra plotfile comps copied through to the output
    # (curvature.cpp:103-106,182-190)
    aux_names = [n for n in pp.query_str_list("Aux_Variables", [])
                 if n not in names]
    names += aux_names
    # floorIt only gates the reference's min/max printout (curvature.cpp:139,
    # no flooring is ever applied).  useFileMinMax=1 (default) always scans
    # the file and user progMin/progMax only widen the range
    # (curvature.cpp:139-148); =0 trusts progMin/progMax verbatim
    pp.query_int("floorIt", 0)
    if not pp.query_bool("useFileMinMax", True):
        if not (pp.contains("progMin") and pp.contains("progMax")):
            raise ValueError("useFileMinMax=0 requires progMin= and progMax=")
    from ..session import dense_state, get_session, load_state, stage_write_plotfile

    state = load_state(
        args, infile, names=names, max_level=pp.query_int("finestLevel", None),
        is_periodic=[bool(p) for p in is_per])
    from ..amr.cluster import needs_clustering

    def _cli_kwargs(pp):
        return dict(
            prog_min=pp.query_float("progMin", None),
            prog_max=pp.query_float("progMax", None),
            do_smooth=pp.query_bool("do_smooth", False),
            smooth_time=pp.query_float("smoothing_time", 1.0e-7),
            smooth_composite=pp.query_bool("smooth_composite", True),
            smooth_iters=pp.query_int("smooth_iters", 50),
            smooth_rtol=(pp.query_float("smooth_rtol", 1.0e-10) or None),
            do_gauss=pp.query_bool("do_gaussCurv", True),
            get_strain_tensor=pp.query_bool("getStrainTensor", False),
            do_threshold=pp.query_bool("threshold_prog", False),
            threshold=pp.query_float(
                "threshold_value", pp.query_float("threshold", 1.0e-4)),
            use_file_minmax=pp.query_bool("useFileMinMax", True),
            replicate_strain_bug=pp.query_bool("replicate_strain_bug",
                                               False),
            sym_dir=pp.query_int_list("sym_dir", [0, 0, 0]),
            interp=pp.query_str("cf_interp", "quadratic"),
        )

    def _main_clustered(pp, state, progress_name, names, aux_names,
                        do_strain, do_velnormal, infile):
        import jax.numpy as jnp

        from ..amr.canonical import (canonical_cluster_substates,
                                     coarse_only_state, global_frame)
        from ..io.plotfile import write_plotfile

        # canonical frames share one compiled engine across equal-bucket
        # clusters (amr/canonical.py); extra_margin=2 keeps the chained
        # grad->N->Hessian stencil stages clear of the coarse-window edge
        groups, subs, base, infos = canonical_cluster_substates(
            state, ngrow_max=1, interp_stencil=1, extra_margin=2)
        if (pp.query_int("ndevices", 1) > 1
                and not any(i.canonical for i in infos)):
            # every cluster is boundary-adjacent: the cluster-axis SPMD
            # cannot run — tell main to honor ndevices via the dense
            # spatial mesh instead of silently dropping the request
            print("curvature: no canonical clusters (boundary-adjacent) "
                  "— ndevices honored via the dense path (higher HBM "
                  "footprint)")
            return False
        meta = state.meta
        fin = meta.n_levels - 1
        kwargs = _cli_kwargs(pp)
        ic = state.comp(progress_name)
        if (kwargs["use_file_minmax"] or kwargs["prog_min"] is None
                or kwargs["prog_max"] is None):
            # GLOBAL progress min/max: a per-cluster scan would normalize
            # each cluster differently.  useFileMinMax combines user bounds
            # with the file scan (min/max), matching curvature.cpp:139-148.
            lo, hi = _file_minmax(
                [(base.data[lev][ic], base.valid_mask(lev))
                 for lev in range(fin)]
                + [(sub.data[fin][ic], sub.valid_mask(fin)) for sub in subs])
            kwargs["prog_min"] = (lo if kwargs["prog_min"] is None
                                  else min(kwargs["prog_min"], lo))
            kwargs["prog_max"] = (hi if kwargs["prog_max"] is None
                                  else max(kwargs["prog_max"], hi))
        # bounds are now resolved globally; stop per-sub rescans
        kwargs["use_file_minmax"] = False
        coarse_out = compute_curvature_dense(
            coarse_only_state(state, base), progress_name,
            do_strain=do_strain, do_velnormal=do_velnormal, **kwargs)
        ndev = pp.query_int("ndevices", 1)
        # cluster-axis SPMD (parallel/cluster_shard.py): default on for
        # ndevices>1; cluster_batch=1 opts in single-device batching
        batch = pp.query_bool("cluster_batch", ndev > 1)
        outs_b = [None] * len(subs)
        if batch and any(i.canonical for i in infos):
            outs_b = _curvature_clusters_batched(
                subs, infos, progress_name, do_strain, do_velnormal,
                kwargs, ndev)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(len(subs), 8)) as ex:
            outs = list(ex.map(
                lambda si: outs_b[si] if outs_b[si] is not None
                else global_frame(compute_curvature_dense(
                    subs[si], progress_name, do_strain=do_strain,
                    do_velnormal=do_velnormal, **kwargs), infos[si]),
                range(len(subs))))
        out_names = list(coarse_out.names) + aux_names
        aux_ic = np.asarray([state.comp(n) for n in aux_names], np.int64)

        def box_fab(src, lev, b, aux_dense=None):
            bbox = src.lmeta[lev].bbox
            sl = tuple(slice(b.lo[d] - bbox.lo[d], b.hi[d] - bbox.lo[d] + 1)
                       for d in range(3))
            fab = np.asarray(src.data[lev][(slice(None),) + sl])
            if aux_dense is not None:
                fab = np.concatenate([fab, aux_dense[(aux_ic,) + sl]],
                                     axis=0)
            return fab

        level_data = []
        for lev in range(fin):
            aux_dense = np.asarray(base.data[lev]) if aux_names else None
            level_data.append([
                box_fab(coarse_out, lev, b, aux_dense)
                for b in meta.bas[lev]])
        # finest level: each box from its cluster's dense output
        boxes = list(meta.bas[fin])
        fine_fabs = [None] * len(boxes)
        for gi, g in enumerate(groups):
            aux_dense = (np.asarray(subs[gi].data[fin])
                         if aux_names else None)
            for i in g:
                fine_fabs[i] = box_fab(outs[gi], fin, boxes[i], aux_dense)
        level_data.append(fine_fabs)
        outfile = pp.query_str("outfile", infile + "_K")
        # shared writer tail: demotes DIM=2 states back to 2-D plotfiles
        from ..amr.hierarchy import write_level_fabs
        write_level_fabs(meta, out_names, level_data, outfile)
        n_can = sum(1 for i in infos if i.canonical)
        print(f"wrote {outfile} ({len(groups)} clusters, "
              f"{n_can} canonical-frame)")

    do_smooth = pp.query_bool("do_smooth", False)
    force_dense = pp.query_bool("force_dense", False)
    sparse = (not force_dense and state.meta.n_levels > 1
              and needs_clustering(state.meta.bas[-1]))
    if sparse and do_smooth:
        ba = state.meta.bas[-1]
        waste = ba.minimal_box().size / max(ba.total_cells(), 1)
        print(f"curvature: finest union bbox is {waste:.1f}x its valid "
              "cells — the composite smoothing solve requires the dense "
              "model (no clustered path); expect the corresponding HBM "
              "footprint or pass finestLevel= to cap levels")
        sparse = False
    if sparse:
        # sparse refinement, local stencils only: per-cluster dense patches
        # (every fill is 1-ghost and clusters are >=3 cells apart, so the
        # per-cluster run equals the global dense run on cluster cells)
        print("curvature: sparse refinement detected -> clustered path")
        if _main_clustered(pp, state, progress_name, names, aux_names,
                           do_strain, do_velnormal, infile) is not False:
            return
        # False: ndevices>1 with no canonical clusters — fall through to
        # the dense spatial-mesh path below
    dstate = dense_state(args, state)
    ndev = pp.query_int("ndevices", 1)
    if ndev > 1:
        from ..parallel.dense_shard import (mesh_from_pp,
                                            shard_dense_state)
        dstate = shard_dense_state(dstate, mesh_from_pp(pp, ndev))
    out = compute_curvature_dense(
        dstate, progress_name,
        do_strain=do_strain, do_velnormal=do_velnormal,
        **_cli_kwargs(pp))
    if aux_names:
        import jax.numpy as jnp
        data = [jnp.concatenate(
            [out.data[lev],
             dstate.data[lev][np.asarray([dstate.comp(n)
                                          for n in aux_names])]], axis=0)
            for lev in range(out.meta.n_levels)]
        out = out.with_data(out.names + aux_names, data)
    outfile = pp.query_str("outfile", infile + "_K")
    sess = get_session(args)
    if sess is not None:
        sess.put_plotfile(outfile, out)
    if stage_write_plotfile(args, out, outfile):
        print(f"wrote {outfile}")
