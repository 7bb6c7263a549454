"""``turbulenceSpectra`` — HIT kinetic-energy spectra and turbulence
statistics.

JAX replacement for the reference's Turbulence_analysis pipeline
(/root/reference/Src/PythonScripts/Turbulence_analysis/: yt + FFTW2 +
AmrDeriveSpectrum + AugmentPlotfile).  The whole chain collapses to: flatten
the hierarchy to a uniform grid, 3-D FFT of the velocity on device
(jnp.fft — runs on the device instead of FFTW/MPI), shell-binned E(k), plus the
time-series statistics (urms, TKE) the yt_post_scrape_tseries script
collects.  Outputs: ``<out>_spectrum.dat`` rows of (k, E(k)) and
``<out>_stats.dat``.
"""
from __future__ import annotations

import numpy as np

from ..amr.hierarchy import AmrState
from ..parmparse import ParmParse
from .flatten_amr import flatten_to_level

VEL = ["x_velocity", "y_velocity", "z_velocity"]


def energy_spectrum(u: np.ndarray, v: np.ndarray, w=None,
                    lengths=(1.0, 1.0, 1.0)):
    """Shell-averaged kinetic-energy spectrum E(k) of a periodic velocity
    field on a uniform grid (2-D or 3-D; pass w=None for 2-D).  Returns
    (k, E) with sum(E) ~ 0.5<|u'|^2>."""
    import jax.numpy as jnp

    vel = [u, v] + ([] if w is None else [w])
    n = u.shape
    ndim = u.ndim
    vol = float(np.prod(n))
    comps = []
    for a in vel:
        ah = jnp.fft.fftn(jnp.asarray(a - a.mean())) / vol
        comps.append(ah)
    e3 = 0.5 * sum(jnp.abs(c) ** 2 for c in comps)
    e3 = np.asarray(e3)
    ks = [np.fft.fftfreq(n[d], d=lengths[d] / n[d]) * lengths[d]
          for d in range(ndim)]
    K = np.meshgrid(*ks, indexing="ij")
    kmag = np.sqrt(sum(k ** 2 for k in K))
    kmax = int(min(nn // 2 for nn in n))
    kbin = np.round(kmag).astype(int)
    # corner modes with |k| > kmax are DROPPED, not clipped into the last
    # shell (r5 review fix: the clip piled ~4x the shell count into E(kmax),
    # corrupting the dissipation-range tail; shell-spectrum codes — the
    # AmrDeriveSpectrum pipeline this replaces — drop them)
    sel = kbin <= kmax
    E = np.zeros(kmax + 1)
    np.add.at(E, kbin[sel].ravel(), e3[sel].ravel())
    return np.arange(kmax + 1), E


def turbulence_stats(u, v, w=None):
    out = {"wrms": 0.0}
    tke = 0.0
    vel = [("u", u), ("v", v)] + ([] if w is None else [("w", w)])
    for nm, a in vel:
        fl = a - a.mean()
        out[f"{nm}rms"] = float(np.sqrt(np.mean(fl**2)))
        tke += 0.5 * float(np.mean(fl**2))
    out["urms_iso"] = float(np.sqrt(2.0 * tke / len(vel)))
    out["tke"] = tke
    return out


def main(args: dict) -> None:
    """CLI: turbulenceSpectra infile=<plt>... [level=finest] [outfile_base=]
    [prefetch=1 — multi-file read-ahead (io/prefetch.py); 0 = serial]"""
    pp = ParmParse(args)
    infiles = pp.get_str_list("infiles" if pp.contains("infiles") else "infile")
    base = pp.query_str("outfile_base", "turb")
    rows = []
    from ..io.plotfile import PlotfileReader
    from ..io.prefetch import iter_states, query_prefetch

    def vel_names(plt):
        avail = PlotfileReader(plt).var_names
        return [n for n in VEL if n in avail]

    # time series: next file's host parse + upload overlaps this file's
    # device FFTs (io/prefetch.py; prefetch=0 restores the serial loop)
    for plt, st in iter_states(args, infiles, names=vel_names,
                               dtype=np.float64,
                               depth=query_prefetch(pp)):
        two_d = getattr(st.meta, "ndim2", False)
        lev = pp.query_int("level", st.meta.n_levels - 1)
        dense = np.asarray(flatten_to_level(st, lev))
        geom = st.meta.geoms[lev]
        L = tuple(h - l for l, h in zip(geom.prob_lo, geom.prob_hi))
        if two_d:
            k, E = energy_spectrum(dense[0][..., 0], dense[1][..., 0],
                                   None, L[:2])
            stats = turbulence_stats(dense[0][..., 0], dense[1][..., 0])
        else:
            k, E = energy_spectrum(dense[0], dense[1], dense[2], L)
            stats = turbulence_stats(dense[0], dense[1], dense[2])
        tag = plt.rstrip("/").split("/")[-1]
        with open(f"{base}_{tag}_spectrum.dat", "w") as f:
            for ki, Ei in zip(k, E):
                f.write(f"{ki} {Ei:e}\n")
        rows.append((st.meta.time, stats))
    with open(f"{base}_stats.dat", "w") as f:
        f.write("# time urms_iso tke urms vrms wrms\n")
        for t, s in rows:
            f.write(f"{t:e} {s['urms_iso']:e} {s['tke']:e} "
                    f"{s['urms']:e} {s['vrms']:e} {s['wrms']:e}\n")
    print(f"wrote {base}_*.dat")
