"""Unified CLI: ``python -m peleanalysis_tpu <tool> key=value... [inputs]``.

One entry point replaces the reference's ~35 separate executables
(/root/reference/Src/GNUmakefile:14-40 EBASE selection) while keeping each
tool's ParmParse key surface.
"""
from __future__ import annotations

import importlib
import os
import sys

from .parmparse import parse_argv

# tool name -> module (each exposes main(args: dict))
TOOLS = {
    "grad": ".tools.grad",
    "interp": ".tools.interp",
    "curvature": ".tools.curvature",
    "isosurface": ".tools.isosurface",
    "buildDistance": ".tools.build_distance",
    "conditionalMean": ".tools.conditional_mean",
    "jpdf": ".tools.jpdf",
    "integral": ".tools.integral",
    "rmsVel": ".tools.rms_vel",
    "combinePlts": ".tools.combine_plts",
    "subPlt": ".tools.sub_plt",
    "regridPlt": ".tools.regrid_plt",
    "flattenAMRFile": ".tools.flatten_amr",
    "avgPlotfiles": ".tools.avg_plotfiles",
    "filterPlt": ".tools.filter_plt",
    "avgToPlane": ".tools.avg_to_plane",
    "slicePlot": ".tools.slice_plot",
    "amrToFE": ".tools.amr_to_fe",
    "template": ".tools.template",
    "turbulenceSpectra": ".tools.turbulence_spectra",
    "turbulenceTseries": ".tools.turbulence_post",
    "turbulenceSlice": ".tools.turbulence_post",
    "augmentPlotfile": ".tools.turbulence_post",
    "varfieldAverage": ".tools.turbulence_post",
    # MEF toolbox
    "isoMEF": ".tools.mef_tools",
    "combineMEF": ".tools.mef_tools",
    "mergeMEF": ".tools.mef_tools",
    "multMEF": ".tools.mef_tools",
    "scaleMEF": ".tools.mef_tools",
    "sliceMEF": ".tools.mef_tools",
    "smoothMEF": ".tools.mef_tools",
    "trimMEFgen": ".tools.mef_tools",
    "binMEF": ".tools.mef_tools",
    "decimateMEF": ".tools.mef_tools",
    "surfDATtoMEF": ".tools.mef_tools",
    "surfMEFtoDAT": ".tools.mef_tools",
    "checkIso": ".tools.mef_tools",
    # streamline subsystem
    "stream": ".tools.stream",
    "partStream": ".tools.part_stream",
    "sampleStreamlines": ".tools.sample_streamlines",
    "stream2plt": ".tools.stream2plt",
    "streamSub": ".tools.stream_sub",
    "streamScatter": ".tools.stream_scatter",
    "streamTubeStats": ".tools.stream_tube_stats",
    # chemistry-aware
    "plotXtoY": ".tools.chem_tools",
    "plotYtoX": ".tools.chem_tools",
    "plotTransportCoeff": ".tools.chem_tools",
    "plotTYtoLe": ".tools.chem_tools",
    "plotQPD": ".tools.chem_tools",
    "sCO2": ".tools.sco2",
    "buildPMF": ".tools.build_pmf",
    # AMReX plotfile-tool analogs every Pele workflow leans on
    "fcompare": ".tools.compare_plts",
    "fextrema": ".tools.compare_plts",
    "doctor": ".tools.doctor",
    "plt2npz": ".tools.plt2npz",
    "npz2plt": ".tools.plt2npz",
}


def main(argv=None, session=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("tools:", " ".join(sorted(TOOLS)), "pipeline serve send")
        return 0
    tool = argv[0]
    if tool in ("pipeline", "serve") or tool in TOOLS:
        from .config import enable_compile_cache
        enable_compile_cache()
    if tool == "pipeline":
        # device-resident tool chaining: stages separated by "--" share one
        # Session (plotfile loads, fills, compiled engines, and intermediate
        # surfaces stay on device; per-stage write=0 skips disk artifacts).
        # The reference's analog is file-chained mains
        # (/root/reference/Src/GNUmakefile:14-40).
        from .session import Session
        sess = session if session is not None else Session(async_writes=True)
        stages, cur = [], []
        for tok in argv[1:]:
            if tok == "--":
                stages.append(cur)
                cur = []
            else:
                cur.append(tok)
        if cur:
            stages.append(cur)
        if not stages or any(not s for s in stages):
            print("pipeline: empty stage (usage: pipeline <tool> k=v ... "
                  "-- <tool> k=v ...)")
            return 2
        rc = 0
        try:
            for stage in stages:
                # a stage may READ a path a previous stage is still
                # writing back (direct PlotfileReader paths bypass the
                # session registry) — settle any matching pending write
                sess.flush_writes(match=stage)
                rc = main(stage, session=sess)
                if rc != 0:
                    break
        finally:
            # exit like a chained reference run: files on disk when the
            # invocation returns.  A failing STAGE outranks a failing
            # write-back: flushing must not mask the stage's rc (or an
            # in-flight exception) with its own raise.
            try:
                sess.flush_writes()
            except Exception as e:
                print(f"pipeline: pending write failed: {e}",
                      file=sys.stderr)
                rc = rc or 1
        return rc
    if tool == "serve":
        # persistent tool server: one process, one Session, warm engines
        # across commands — the AOT-binary startup-cost analog (server.py)
        from .server import serve
        return serve(parse_argv(argv[1:])) or 0
    if tool == "send":
        # thin client for a running server: send [socket=S] <tool> k=v...
        from .server import send
        rest = argv[1:]
        skeys = []
        while rest and (rest[0].startswith("socket=")
                        or rest[0].startswith("sync=")):
            skeys.append(rest.pop(0))
        return send(parse_argv(skeys), rest)
    if tool not in TOOLS:
        print(f"unknown tool '{tool}'. tools: {' '.join(sorted(TOOLS))}"
              " pipeline serve send")
        return 2
    mod = importlib.import_module(TOOLS[tool], package=__package__)
    args = parse_argv(argv[1:])
    args.setdefault("_tool", [tool])
    if session is not None:
        args["_session"] = session
    # Global dtype= key: float64 gives the reference's double-precision
    # compute end-to-end on every tool (grad/curvature/isosurface/stream
    # included), not just the stats tools' accumulators.  The default stays
    # float32.
    dt = args.get("dtype")
    if dt:
        import jax
        import jax.numpy as jnp

        from . import config
        name = dt[0] if isinstance(dt, list) else dt
        if name in ("float64", "f64", "double"):
            jax.config.update("jax_enable_x64", True)
            config.set_compute_dtype(jnp.float64)
        elif name in ("float32", "f32", "single"):
            config.set_compute_dtype(jnp.float32)
        else:
            print(f"unknown dtype '{name}' (float32|float64)")
            return 2
    else:
        # each main() is one tool invocation: a prior dtype=float64 run in
        # the same process (tests, pipeline, server) must not leak into a
        # default-precision run (x64 stays enabled — only the compute dtype
        # selects what loads/engines produce)
        import jax.numpy as jnp

        from . import config
        config.set_compute_dtype(jnp.float32)
    from .parmparse import _ACTIVE
    _ACTIVE.clear()
    # PELE_PROFILE=<dir>: wrap the tool in a jax.profiler trace (the
    # analog of the reference's BL_PROFILE / TinyProfiler regions, SURVEY §5)
    prof_dir = os.environ.get("PELE_PROFILE", "")
    if prof_dir:
        import jax

        with jax.profiler.trace(prof_dir):
            mod.main(args)
        print(f"profile trace written to {prof_dir}")
    else:
        mod.main(args)
    # the reference silently ignores unknown ParmParse keys; a typo'd key
    # costs real debugging time, so warn (stderr, non-fatal)
    touched = set().union(*(pp.touched for pp in _ACTIVE)) if _ACTIVE else set()
    unused = set(args) - touched - {"_tool", "dtype", "_session"}
    if session is not None:
        unused -= {"write"}   # pipeline-mode key; outside a pipeline an
        #                       ignored write= should WARN like any typo
    if unused:
        print(f"warning: unused input keys (typo?): {' '.join(sorted(unused))}",
              file=sys.stderr)
    _ACTIVE.clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
