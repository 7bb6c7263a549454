"""``isosurface`` — marching-cubes isosurface of a plotfile variable -> MEF.

JAX replacement for PeleAnalysis Src/isosurface.cpp (2269 LoC);
the engine lives in peleanalysis_tpu/geom/marching_cubes.py.  CLI keys match
isosurface.cpp:1295-1399,1894-2238: infile, isoCompName (default temp),
isoVal, comps (extra node fields), finestLevel, is_per, writeSurf,
outfile_base, computeArea; build_distance_function via the ``buildDistance``
tool / geom.sdf.
"""
from __future__ import annotations

import numpy as np

from ..native import savetxt_fast

from ..amr.dense import DenseAmrState
from ..amr.hierarchy import AmrState
from ..geom.marching_cubes import extract_isosurface, surface_area
from ..io.mef import write_mef, write_mef_tecplot
from ..parmparse import ParmParse


def main(args: dict) -> None:
    """CLI: isosurface infile= [isoCompName=temp] [isoVal=1000]
    [comps=<extra node fields>] [finestLevel=] [is_per=0 0 0]
    [writeSurf=1] [surfFormat=MEF|DAT|XDMF] [outfile_base=]
    [computeArea=0] [engine=enum|device|fused|numpy]
    [build_distance_function=0 dmax= dist_outfile=] [surface_is_large=0]
    [ndevices=1 mesh_shape=] [shape_bucket=0]
    [cluster_batch=0|1  (sparse path: batch canonical clusters into one
    vmapped enum dispatch + one packed fetch; default 1 iff ndevices>1,
    where the batch axis also shards over the cluster mesh)]"""
    from ..io.plotfile import PlotfileReader
    from ..utils import phase, report

    pp = ParmParse(args)
    verbose = pp.query_int("verbose", 0)
    infile = pp.get_str("infile")
    iso_name = pp.query_str("isoCompName", "temp")
    iso_val = pp.query_float("isoVal", 1000.0)
    is_per = pp.query_int_list("is_per", [0, 0, 0])
    finest = pp.query_int("finestLevel", None)

    var_names = PlotfileReader(infile).var_names
    extras = pp.query_str_list("comps", [])
    extras = [var_names[int(c)] if c.isdigit() else c for c in extras]
    if pp.contains("sComp") or pp.contains("nComp"):
        # reference-style comp-range selection (isosurface.cpp sComp/nComp)
        s = pp.query_int("sComp", 0)
        n = pp.query_int("nComp", 1)
        extras = extras + [v for v in var_names[s: s + n]
                           if v not in extras]
    if not pp.query_bool("rm_external_elements", True):
        print("isosurface: rm_external_elements=0 ignored — the canonical "
              "per-edge engine never emits duplicate/overlap elements "
              "(the reference's per-box g1box filter has no analog here)")

    from ..session import dense_state, get_session, load_state, stage_writes

    load = [iso_name] + [n for n in extras if n != iso_name]
    with phase("isosurface I/O"):
        st = load_state(args, infile, names=load, max_level=finest,
                        is_periodic=[bool(p) for p in is_per],
                        dtype=np.float64)
        from ..amr.cluster import needs_clustering
        fin = st.meta.n_levels - 1
        # surface_is_large=1 is the reference's disk-staged memory valve
        # (isosurface.cpp:1919-1998): here the clustered path IS the valve —
        # peak HBM scales with one cluster + the merged host surface, so
        # forcing it honors the same intent without a tmpFile
        force_sparse = pp.query_bool("surface_is_large", False)
        sparse = (not st.meta.ndim2 and st.meta.n_levels > 1
                  and (force_sparse or needs_clustering(st.meta.bas[fin]))
                  and not pp.query_bool("force_dense", False))
        ds = None if sparse else dense_state(args, st)
        ndev = pp.query_int("ndevices", 1)
        if ds is not None and ndev > 1:
            from ..parallel.dense_shard import (mesh_from_pp,
                                                shard_dense_state)
            ds = shard_dense_state(ds, mesh_from_pp(pp, ndev))
    if st.meta.ndim2:
        # DIM=2 plotfile: marching squares -> polyline contour MEF
        from ..geom.marching_squares import extract_isolines
        with phase("Compute Surface"):
            mef = extract_isolines(ds, iso_name, iso_val, extras,
                                   label=f"{st.meta.time:g}")
    elif sparse:
        # sparse refinement: process the finest level as dense clusters so
        # HBM scales with valid cells, not the union bbox (amr/cluster.py)
        from ..geom.marching_cubes import extract_isosurface_sparse
        print("isosurface: sparse refinement detected -> clustered path")
        with phase("Compute Surface"):
            # ndevices>1: cluster-axis SPMD — canonical clusters batch into
            # one vmapped dispatch sharded over the mesh; cluster_batch=1
            # opts in single-device batching (one dispatch + one fetch)
            mef = extract_isosurface_sparse(
                st, iso_name, iso_val, extras, label=f"{st.meta.time:g}",
                ndevices=ndev,
                cluster_batch=pp.query_bool("cluster_batch", None))
    else:
        engine = pp.query_str("engine", "enum")  # enum|device|fused|numpy
        # pipeline stage with write=0: keep the surface payload on device —
        # a downstream stream stage fetches only the seed xyz columns
        defer = (get_session(args) is not None and not stage_writes(args)
                 and engine == "enum")
        with phase("Compute Surface"):
            mef = extract_isosurface(ds, iso_name, iso_val, extras,
                                     label=f"{st.meta.time:g}",
                                     classify=engine, defer=defer)
    base = pp.query_str("outfile_base", f"{infile}_{iso_name}_{iso_val:g}")
    sess = get_session(args)
    if sess is not None:
        # downstream stages (stream isoFile=, MEF tools) resolve these
        # names from the session before touching disk
        sess.put_surface(base + ".mef", mef)
        sess.put_surface(base + ".dat", mef)
    if pp.query_bool("writeSurf", True) and stage_writes(args):
        # the surface is already decoded host-side on this path (defer only
        # happens with write=0): the file writes are write-back eligible
        from ..session import stage_submit_io
        fmt = pp.query_str("surfFormat", "MEF")
        if fmt.upper() == "MEF":
            stage_submit_io(args, base + ".mef",
                            lambda: write_mef(base + ".mef", mef))
            print(f"wrote {base}.mef  ({mef.n_nodes} nodes, "
                  f"{mef.n_elts} elements)")
        elif fmt.upper() == "XDMF":
            from ..io.xdmf import write_xdmf
            write_xdmf(base, mef, iso_name, iso_val, st.meta.time)
            print(f"wrote {base}.xmf/.mesh")
        else:
            stage_submit_io(args, base + ".dat",
                            lambda: write_mef_tecplot(base + ".dat", mef))
            print(f"wrote {base}.dat")
    if pp.query_bool("computeArea", False):
        m = mef.to_mef() if hasattr(mef, "to_mef") else mef
        print(f"Total area of surface: {surface_area(m):.10g}")
    if pp.query_bool("build_distance_function", False):
        # in-run signed-distance plotfile from the same invocation
        # (isosurface.cpp:1595-1654 per-box make_level_set3 + :1732-1748
        # WriteMultiLevelPlotfile); sign overridden by field<isoVal like
        # isosurface.cpp:1644
        if st.meta.ndim2:
            raise ValueError("build_distance_function requires DIM=3")
        if sparse:
            raise ValueError(
                "build_distance_function is not supported on the sparse "
                "clustered path yet; pass force_dense=1 to accept the "
                "union-bbox footprint")
        import jax.numpy as jnp
        from ..geom.sdf import signed_distance_dense
        if hasattr(mef, "to_mef"):
            mef = mef.to_mef()
        fin = st.meta.n_levels - 1
        dmax = pp.query_float("dmax", 4.0 * st.meta.geoms[fin].dx[0])
        with phase("Distance"):
            out_levels = []
            for lev in range(st.meta.n_levels):
                phi = signed_distance_dense(ds, mef, lev, dmax,
                                            sign_field=iso_name,
                                            iso_val=iso_val)
                out_levels.append(jnp.asarray(np.asarray(phi)[None]))
        dist_out = ds.with_data(["distance"], out_levels)
        # the reference names the distance plotfile with `outfile`
        # (isosurface.cpp:1734); dist_outfile kept as the explicit alias
        dist_file = pp.query_str(
            "dist_outfile", pp.query_str("outfile", infile + "_dist"))
        dist_out.to_plotfile(dist_file)
        print(f"wrote {dist_file}")
    if verbose:
        # reference-style phase report (isosurface.cpp:1756-1772 timers)
        report()
    if st.meta.ndim2 and pp.query_bool("writeLines", False):
        # MakeCLines polyline assembly (isosurface.cpp:1159-1271)
        from ..geom.mef_tools import assemble_polylines
        chains = assemble_polylines(mef)
        with open(base + "_lines.dat", "w") as f:
            f.write("VARIABLES = " + " ".join(mef.names) + "\n")
            for ci, chain in enumerate(chains):
                f.write(f'ZONE T="line{ci}" I={len(chain)} '
                        "DATAPACKING=POINT\n")
                savetxt_fast(f, mef.nodes[chain], fmt="%.9g")
        print(f"wrote {base}_lines.dat ({len(chains)} polylines)")
