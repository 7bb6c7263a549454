"""``rmsVel`` — u' RMS per plotfile in a time series.

JAX replacement for PeleAnalysis Src/rmsVel.cpp (142 LoC): reads
x/y/z_velocity at the finest level only, accumulates volume-weighted <u> and
<u^2> (rmsVel.cpp:82-116), writes "RmsVel.dat" rows of (time, urms) with
urms = sqrt(mean over dims of (<u_d^2> - <u_d>^2)) (rmsVel.cpp:125-127).
"""
from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np

from ..amr.dense import DenseAmrState
from ..amr.hierarchy import AmrState
from ..parmparse import ParmParse

VEL = ["x_velocity", "y_velocity", "z_velocity"]


def rms_velocity(ds: DenseAmrState) -> float:
    """Finest-level-only, matching the reference (all finest cells count —
    no covered-mask since nothing covers the finest level).  2-D plotfiles
    average over the two in-plane components."""
    fin = ds.meta.n_levels - 1
    vel = VEL[:2] if getattr(ds.meta, "ndim2", False) else VEL
    m = ds.in_level_mask(fin)
    vol = float(np.sum(np.asarray(m)))
    var_sum = 0.0
    for name in vel:
        u = ds.data[fin][ds.comp(name)]
        ub = float(jnp.sum(jnp.where(m, u, 0.0))) / vol
        u2 = float(jnp.sum(jnp.where(m, u * u, 0.0))) / vol
        var_sum += u2 - ub * ub
    return float(np.sqrt(var_sum / len(vel)))


def main(args: dict) -> None:
    """CLI: rmsVel infile=<plt>... [finestLevel=] [outfile=RmsVel.dat]
    [prefetch=1 — multi-file read-ahead (io/prefetch.py); 0 = serial]"""
    pp = ParmParse(args)
    infiles = pp.get_str_list("infiles" if pp.contains("infiles") else "infile")
    finest = pp.query_int("finestLevel", None)
    out = pp.query_str("outfile", "RmsVel.dat")
    rows = []
    from ..io.plotfile import PlotfileReader
    from ..io.prefetch import iter_states, query_prefetch

    def vel_names(plt):
        avail = PlotfileReader(plt).var_names
        vel = [n for n in VEL if n in avail]
        if len(vel) < 2:
            raise ValueError(f"{plt}: no velocity components found "
                             f"(have {avail})")
        return vel

    # time series: next file's host parse + upload overlaps this file's
    # device reductions (io/prefetch.py; prefetch=0 restores serial)
    for plt, st in iter_states(args, infiles, names=vel_names,
                               max_level=finest,
                               depth=query_prefetch(pp)):
        ds = DenseAmrState.from_batched(st)
        rows.append((st.meta.time, rms_velocity(ds)))
    with open(out, "w") as f:
        for t, u in rows:
            f.write(f"{t:e} {u:e}\n")
    print(f"wrote {out}")
