"""``partStream`` — particle-style streamline tracing along the velocity
field (/root/reference/Src/partStream.cpp + StreamPC.{H,cpp}).

The reference reimplements streamlines with an AMReX ParticleContainer that
Redistributes particles across ranks every step (StreamPC.cpp:86-141).  Here
all lines stay resident in device memory, so the same engine as ``stream`` applies
(SURVEY.md §5 "resident-batch" note); seeding modes match partStream.cpp:8-119
(oneSeedPerCell / isoFile / seedLoc / seedRake), stepping matches the per-step
RK4 + ntrpv (StreamPC.cpp:143-259).  Output: Tecplot lines
(WriteStreamAsTecplot, StreamPC.cpp:308-373) and/or StreamData.
"""
from __future__ import annotations

import numpy as np

from ..amr.dense import DenseAmrState
from ..amr.hierarchy import AmrState
from ..io.mef import read_mef
from ..io.stream_data import StreamData, compute_inside_nodes, write_stream_data
from ..parmparse import ParmParse
from ..stream.trace import seed_rake, trace_streamlines
from .stream import write_tecplot_lines


def seeds_one_per_cell(ds: DenseAmrState, stride: int = 1) -> np.ndarray:
    """Seed at every valid finest-level cell center (partStream.cpp:8-40);
    optional stride thins the cloud."""
    lev = ds.meta.n_levels - 1
    geom = ds.meta.geoms[lev]
    bbox = ds.lmeta[lev].bbox
    m = ds.in_level_mask_np(lev)
    idx = np.argwhere(m)[::stride]
    dx = np.array(geom.dx)
    return (np.array(geom.prob_lo)
            + (idx + np.array(bbox.lo) - np.array(geom.domain.lo) + 0.5) * dx)


def main(args: dict) -> None:
    """CLI: partStream infile= [oneSeedPerCell=1 | isoFile= | seedLoc= |
    seedRakeL= seedRakeR= seedRakeNum=] [Nsteps=51] [hRK=0.1]
    [outFile=] [streamFile=] [seedStride=1]"""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    n_steps = pp.query_int("Nsteps", 51)
    h_rk = pp.query_float("hRK", 0.1)

    from ..io.plotfile import PlotfileReader
    vel = [v for v in ("x_velocity", "y_velocity", "z_velocity")
           if v in PlotfileReader(infile).var_names]
    from ..session import load_state
    st = load_state(args, infile, names=vel,
                                max_level=pp.query_int("finestLevel", None),
                                dtype=np.float64)
    from ..amr.cluster import needs_clustering
    force_dense = pp.query_bool("force_dense", False)
    sparse = (not force_dense and st.meta.n_levels > 1
              and pp.query_int("ndevices", 0) <= 1
              and not pp.query_bool("oneSeedPerCell", False)
              and needs_clustering(st.meta.bas[-1]))
    ds = None if sparse else DenseAmrState.from_batched(st)

    elements = np.zeros((0, 3), np.int32)
    if pp.query_bool("oneSeedPerCell", False):
        seeds = seeds_one_per_cell(ds, pp.query_int("seedStride", 1))
    elif pp.contains("isoFile"):
        mef = read_mef(pp.get_str("isoFile"))
        seeds, elements = mef.positions(), mef.elements
    elif pp.contains("seedLoc"):
        seeds = np.array([pp.get_float_list("seedLoc")[:3]])
    elif pp.contains("seedRakeL"):
        seeds = seed_rake(pp.get_float_list("seedRakeL")[:3],
                          pp.get_float_list("seedRakeR")[:3],
                          pp.query_int("seedRakeNum", 10))
    else:
        raise ValueError("specify a seed source")

    if pp.query_int("ndevices", 0) > 1:
        # multi-chip Redistribute path (StreamPC.cpp:86-141): grown fields
        # staged to per-device X slabs, per-step ppermute migration
        import jax
        from jax.sharding import Mesh
        from ..parallel.particles import trace_streamlines_migrating
        ndev = pp.query_int("ndevices", 0)
        mesh = Mesh(np.array(jax.devices()[:ndev]), ("parts",))
        lines = trace_streamlines_migrating(
            ds, seeds, n_steps, h_rk,
            mesh, capacity=pp.query_int("capacity", None))
    elif sparse:
        # sparse refinement: clustered per-region marches (exact; see
        # stream/trace.trace_streamlines_sparse)
        print("partStream: sparse refinement detected -> clustered path")
        from ..stream.trace import trace_streamlines_sparse
        lines = trace_streamlines_sparse(st, seeds, n_steps, h_rk,
                                         trace_field=None, sample_names=())
    else:
        lines = trace_streamlines(ds, seeds, n_steps, h_rk, trace_field=None,
                                  sample_names=(),
                                  ngrow=pp.query_int("nGrow", None))
    names = ["X", "Y", "Z"]
    out = pp.query_str("outFile", infile + "_stream.dat")
    write_tecplot_lines(out, names, lines)
    print(f"wrote {out} ({lines.shape[0]} lines)")
    if pp.contains("partFile"):
        # AMReX particle plotfile (StreamPC's WritePlotFile analog): the
        # particle position is the final path point; the whole path rides in
        # the runtime real comps (StreamPC.cpp:14-35, Nsteps*SPACEDIM reals)
        from ..io.particles import write_particles
        npts = lines.shape[1]
        real_comps = {}
        for j in range(npts):
            for d, ax in enumerate("xyz"):
                real_comps[f"path_{j:03d}_{ax}"] = lines[:, j, d]
        write_particles(pp.get_str("partFile"), lines[:, -1, :3],
                        real_comps=real_comps)
        print(f"wrote {pp.get_str('partFile')}/particles")
    if pp.contains("streamFile"):
        inside = compute_inside_nodes(st.meta,
                                      lines[:, lines.shape[1] // 2, :3])
        sd = StreamData(names, elements, inside, lines)
        write_stream_data(pp.get_str("streamFile"), sd)
        print(f"wrote {pp.get_str('streamFile')}")
