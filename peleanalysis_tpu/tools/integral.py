"""``integral`` — volume / plane / line integrals over the valid AMR
hierarchy.

JAX replacement for PeleAnalysis Src/integral.cpp (588 LoC):
  * integralDimension=1: integrate along ``dir`` -> 2-D field over
    (dir1,dir2) at finest resolution (integrate1d, integral.cpp:13-72)
  * integralDimension=2: integrate over (dir1,dir2) -> 1-D profile along
    ``dir`` (integrate2d, integral.cpp:74-120)
  * integralDimension=3: full volume integral -> scalars (integrate3d,
    integral.cpp:122-148)
Covered cells are masked; optional conditioning window
``cVar in [cMin,cMax)``; ``avg=1`` divides by the accumulated measure.
Coarse contributions are replicated onto the finest-grid output columns
exactly as the reference's refRatio loops do (integral.cpp:31-40).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..amr.dense import DenseAmrState
from ..amr.hierarchy import AmrState
from ..parmparse import ParmParse


def _cond_mask(ds: DenseAmrState, lev: int, c_name: Optional[str],
               c_min: float, c_max: float):
    m = ds.valid_mask(lev)
    if c_name is not None:
        c = ds.data[lev][ds.comp(c_name)]
        m = m & (c >= c_min) & (c < c_max)
    return m


def _ratio_to_finest(meta, lev: int, d: int) -> int:
    """Per-dimension refinement factor lev -> finest (1 along degenerate
    dims of promoted DIM=2 plotfiles)."""
    fin = meta.n_levels - 1
    return (meta.geoms[fin].domain.shape[d]
            // meta.geoms[lev].domain.shape[d])


def integrate_along(ds: DenseAmrState, var_names: Sequence[str],
                    int_dirs: Sequence[int],
                    c_name: Optional[str] = None,
                    c_min: float = 0.0, c_max: float = 1.0,
                    avg: bool = False):
    """Integrate var fields (and the measure) along ``int_dirs``; returns
    (coords, weight, fields) on the finest-grid extents of the remaining
    dims (full-volume when int_dirs has all 3 dims -> scalars)."""
    meta = ds.meta
    rem = [d for d in range(3) if d not in int_dirs]
    fin = meta.n_levels - 1
    fin_dom = meta.geoms[fin].domain
    out_shape = tuple(fin_dom.shape[d] for d in rem)
    acc_w = np.zeros(out_shape if rem else ())
    accs = [np.zeros(out_shape if rem else ()) for _ in var_names]

    for lev in range(meta.n_levels):
        geom = meta.geoms[lev]
        w = float(np.prod([geom.dx[d] for d in int_dirs]))
        mask = _cond_mask(ds, lev, c_name, c_min, c_max)
        axes = tuple(int_dirs)
        rs = [_ratio_to_finest(meta, lev, d) for d in rem]
        bbox = ds.lmeta[lev].bbox

        def to_out(a):
            a = np.asarray(a)
            for k in range(len(rem)):
                a = np.repeat(a, rs[k], axis=k)
            return a

        part_w = jnp.sum(jnp.where(mask, 1.0, 0.0) * w, axis=axes)
        parts = [jnp.sum(jnp.where(mask, ds.data[lev][ds.comp(n)], 0.0) * w,
                         axis=axes) for n in var_names]
        if rem:
            off = tuple(bbox.lo[rem[k]] * rs[k] - fin_dom.lo[rem[k]]
                        for k in range(len(rem)))
            sl = tuple(slice(off[k], off[k] + part_w.shape[k] * rs[k])
                       for k in range(len(rem)))
            acc_w[sl] += to_out(part_w)
            for n, p in enumerate(parts):
                accs[n][sl] += to_out(p)
        else:
            acc_w += float(part_w)
            for n, p in enumerate(parts):
                accs[n] += float(p)

    if avg:
        nz = acc_w > 0.0
        accs = [np.where(nz, a / np.where(nz, acc_w, 1.0), a) if rem
                else (a / acc_w if acc_w > 0 else a) for a in accs]
    geomf = meta.geoms[fin]
    coords = [geomf.prob_lo[d] + (np.arange(fin_dom.shape[d]) + 0.5)
              * geomf.dx[d] for d in rem]
    return coords, acc_w, accs


def write_dat_1d(path: str, vec) -> None:
    with open(path, "w") as f:
        f.write(" ".join(f"{v:e}" for v in np.asarray(vec).ravel()))
        f.write("\n")


def write_dat_2d(path: str, arr) -> None:
    with open(path, "w") as f:
        for row in np.asarray(arr):
            f.write(" ".join(f"{v:e}" for v in row) + "\n")


def _pele_ppm_rgb(c: np.ndarray, go_past_max: bool) -> np.ndarray:
    """The reference's exact writePPM colormap (integral.cpp:247-295):
    c = clamp((v-vmin)/(vmax-vmin), 0, 1.5); over-max values render as the
    magenta->white ramp when go_past_max, else dark red."""
    r = np.zeros_like(c)
    g = np.zeros_like(c)
    b = np.zeros_like(c)

    def seg(m, rr, gg, bb):
        r[m], g[m], b[m] = (np.broadcast_to(v, c[m].shape)
                            for v in (rr, gg, bb))

    m = c < 0.125
    seg(m, 0.0, 0.0, (c[m] + 0.125) * 4.0)
    m = (c >= 0.125) & (c < 0.375)
    seg(m, 0.0, (c[m] - 0.125) * 4.0, 1.0)
    m = (c >= 0.375) & (c < 0.625)
    seg(m, (c[m] - 0.375) * 4.0, 1.0, (0.625 - c[m]) * 4.0)
    m = (c >= 0.625) & (c < 0.875)
    seg(m, 1.0, (0.875 - c[m]) * 4.0, 0.0)
    m = (c >= 0.875) & (c < 1.0)
    seg(m, (1.125 - c[m]) * 4.0, 0.0, 0.0)
    if go_past_max:
        m = (c >= 1.0) & (c < 1.125)
        seg(m, (c[m] - 0.875) * 4.0, 0.0, (c[m] - 1.0) * 4.0)
        m = (c >= 1.125) & (c < 1.25)
        seg(m, 1.0, 0.0, (c[m] - 1.0) * 4.0)
        m = (c >= 1.25) & (c < 1.5)
        seg(m, 1.0, (c[m] - 1.25) * 4.0, 1.0)
        m = c >= 1.5
        seg(m, 1.0, 1.0, 1.0)
    else:
        m = c >= 1.0
        seg(m, 128.0 / 255.0, 0.0, 0.0)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 1)


def write_ppm(path: str, arr, vmin=None, vmax=None,
              palette="rainbow", go_past_max: bool = False) -> None:
    """P6 PPM render (integral.cpp:300 / slicePlot's palette rendering).
    palette: "rainbow" (blue->cyan->green->yellow->red, the amrvis-style
    default), "pele" (the reference's exact writePPM map, with goPastMax),
    "gray", or an [N,3] uint8 LUT (an amrvis .pal, the reference's
    loadPalette at slicePlot.cpp:73-80)."""
    a = np.asarray(arr, dtype=np.float64)
    vmin = a.min() if vmin is None else vmin
    vmax = a.max() if vmax is None else vmax
    if isinstance(palette, str) and palette == "pele":
        c = np.clip((a - vmin) / max(vmax - vmin, 1e-300), 0, 1.5)
        img = (_pele_ppm_rgb(c, go_past_max) * 255).astype(np.uint8)
        with open(path, "wb") as f:
            f.write(f"P6\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
            img.tofile(f)
        return
    x = np.clip((a - vmin) / max(vmax - vmin, 1e-300), 0, 1)
    if isinstance(palette, np.ndarray):
        lut = palette
        img = lut[np.clip((x * (len(lut) - 1)).astype(np.int64),
                          0, len(lut) - 1)].astype(np.uint8)
        with open(path, "wb") as f:
            f.write(f"P6\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
            img.tofile(f)
        return
    if palette == "gray":
        rgb = np.stack([x, x, x], axis=-1)
    else:
        # piecewise-linear rainbow
        r = np.clip(np.minimum(4 * x - 2, 4.5 - 4 * x), 0, 1)
        g = np.clip(np.minimum(4 * x, 3.5 - 4 * x + 1), 0, 1) \
            * (x < 0.9) + np.clip(4.5 - 4 * x, 0, 1) * (x >= 0.9)
        b = np.clip(np.minimum(1.5 + 4 * x - 1, 2.5 - 4 * x), 0, 1)
        rgb = np.stack([r, g, b], axis=-1)
    img = (rgb * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        img.tofile(f)


def write_pgm(path: str, arr, vmin=None, vmax=None) -> None:
    """True P5 grayscale PGM (the reference's STORE_PGM_STR path,
    slicePlot.cpp:86-88,137-138): one byte per pixel, no RGB triples."""
    a = np.asarray(arr, dtype=np.float64)
    vmin = a.min() if vmin is None else vmin
    vmax = a.max() if vmax is None else vmax
    x = np.clip((a - vmin) / max(vmax - vmin, 1e-300), 0, 1)
    img = (x * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        img.tofile(f)


def main(args: dict) -> None:
    """CLI: integral infile=<plt> vars=<names> integralDimension=1|2|3
    [dir=/dir1=/dir2=] [cVar= cMin= cMax=] [avg=0] [finestLevel=]
    [format=dat|ppm] [outfile_base=]"""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    var_names = pp.get_str_list("vars")
    idim = pp.get_int("integralDimension")
    c_name = pp.query_str("cVar", None)
    c_min = pp.query_float("cMin", 0.0)
    c_max = pp.query_float("cMax", 1.0)
    avg = pp.query_bool("avg", False)
    finest = pp.query_int("finestLevel", None)
    fmt = pp.query_str("format", "dat")
    base = pp.query_str("outfile_base", infile + "_int")

    load = list(var_names) + ([c_name] if c_name else [])
    from ..session import load_state
    st = load_state(args, infile, names=load, max_level=finest)
    ds = DenseAmrState.from_batched(st)

    if idim == 1:
        d = pp.get_int("dir")
        int_dirs = [d]
    elif idim == 2:
        d1, d2 = pp.get_int("dir1"), pp.get_int("dir2")
        int_dirs = [d1, d2]
    elif idim == 3:
        int_dirs = [0, 1, 2]
    else:
        raise ValueError("integralDimension must be 1, 2 or 3")

    coords, w, fields = integrate_along(ds, var_names, int_dirs,
                                        c_name, c_min, c_max, avg)
    if idim == 3:
        print("weight:", float(w))
        for n, v in zip(var_names, fields):
            print(f"{n}: {float(v):e}")
        with open(base + ".dat", "w") as f:
            f.write(" ".join([f"{float(w):e}"]
                             + [f"{float(v):e}" for v in fields]) + "\n")
    elif idim == 2:
        write_dat_1d(base + "_x.dat", coords[0])
        for n, v in zip(var_names, fields):
            write_dat_1d(f"{base}_{n}.dat", v)
    else:
        write_dat_1d(base + "_x.dat", coords[0])
        write_dat_1d(base + "_y.dat", coords[1])
        for i, (n, v) in enumerate(zip(var_names, fields)):
            if fmt == "ppm":
                # per-variable useminmax<n>=lo hi (1-based, like jpdf /
                # integral.cpp useminmax%i); vMin=/vMax= kept as global
                # aliases.  goPastMax defaults ON (integral.cpp:464-465).
                vmin = pp.query_float("vMin", None)
                vmax = pp.query_float("vMax", None)
                mm = pp.query_float_list(f"useminmax{i + 1}", None)
                if mm:
                    vmin, vmax = mm[0], mm[1]
                write_ppm(f"{base}_{n}.ppm", v, palette="pele",
                          vmin=vmin, vmax=vmax,
                          go_past_max=pp.query_int("goPastMax", 1) == 1)
            else:
                write_dat_2d(f"{base}_{n}.dat", v)
    print(f"wrote {base}*")
