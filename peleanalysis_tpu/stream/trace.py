"""Streamline integration engine — the JAX vtrace.

Replaces the reference's per-box Fortran kernel stack
(/root/reference/Src/stream.cpp:888-934 + Src/stream_nd.f90):

  * seeds are assigned to the finest level containing them, with finer-box
    exclusion (setInsideNodes, stream.cpp:140-215)
  * per level, ONE dense grown array with ghost radius
    nGrow = ceil(hRK*nRKsteps/2) + 2 guarantees every path stays inside the
    sampled region (the grow-box strategy, stream.cpp:700-720 and
    Docs/source/stream.rst "Algorithm details")
  * the ±RK4 march is a jitted lax.scan vmapped over all of a level's seeds
    at once — the whole per-level vtrace is one fused kernel
  * trilinear sampling matches ntrpv's cell-centered dual-grid math
    ``base = floor((x-plo)/dx - 0.5)`` with clamping (stream_nd.f90:153-206)
  * each RK4 stage normalizes the sampled vector (stream_nd.f90:116-151 RK4 +
    vnrml), so the parameter is arclength
  * tracing "up the gradient" computes the central-difference gradient of a
    scalar on the grown array first (stream_nd.f90:33-45), or uses the
    velocity components directly.

Paths are stored as [nseed, 2*nRKh+1, 3+nfields]: j index = arclength
station with j=nRKh at the seed (matching the reference's FAB j=0-on-seed
layout after the -nRKh offset).
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..amr.dense import DenseAmrState
from ..ops.dense_fill import fill_dense_arrays, fill_dense_multilevel
from ..ops.stencil import centered_gradient

# corner order of the trilinear stencil (i,j,k offsets)
# cross-instance cache of the per-level jitted march engines (see
# amr/dense.py shared_engine): repeated CLI runs over a time series stop
# re-tracing the fill+march graph per plotfile
_GLOBAL_TRACE_FNS = {}

CORNER_OFFSETS_S = np.array(
    [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
     (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)], dtype=np.int64)


def assign_seeds_to_levels(dstate: DenseAmrState,
                           seeds: np.ndarray) -> np.ndarray:
    """Owner level per seed: finest level whose union contains the seed
    (setInsideNodes with fine-box exclusion, stream.cpp:140-215)."""
    meta = dstate.meta
    owner = np.zeros(len(seeds), dtype=np.int32)
    for lev in range(meta.n_levels):
        geom = meta.geoms[lev]
        bbox = dstate.lmeta[lev].bbox
        dx = np.array(geom.dx)
        idx = np.floor((seeds - np.array(geom.prob_lo)) / dx).astype(np.int64)
        idx += np.array(geom.domain.lo)
        loc = idx - np.array(bbox.lo)
        inside = np.all((loc >= 0) & (loc < np.array(bbox.shape)), axis=1)
        mask = dstate.in_level_mask_np(lev)
        li = np.clip(loc, 0, np.array(bbox.shape) - 1)
        inlev = mask[li[:, 0], li[:, 1], li[:, 2]] & inside
        owner[inlev] = lev
    return owner


def push_nodes_inside(seeds: np.ndarray, geom, eps_frac: float = 1.0e-4
                      ) -> np.ndarray:
    """Nudge seeds strictly inside the domain (push_nodes_inside,
    stream.cpp:122-138)."""
    lo = np.array(geom.prob_lo)
    hi = np.array(geom.prob_hi)
    eps = eps_frac * np.array(geom.dx)
    return np.clip(seeds, lo + eps, hi - eps)


@partial(jax.jit, static_argnames=("n_steps",))
def _trace_level(vec: jnp.ndarray, fields: jnp.ndarray, plo_g: jnp.ndarray,
                 dx: jnp.ndarray, h, seeds: jnp.ndarray, n_steps: int,
                 direction) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """March seeds n_steps in ±direction.  vec: [3, SX,SY,SZ] (grown),
    fields: [nf, SX,SY,SZ]; returns (pos [n_steps+1, ns, 3],
    ok [ns] all-samples-in-range flag)."""
    shape = jnp.asarray(vec.shape[1:])

    _, NY, NZ = vec.shape[1], vec.shape[2], vec.shape[3]
    # the 8 dual-cell corners as offsets into the flattened [X,Y,Z] volume:
    # ONE batched gather per interpolation instead of 8
    corner_off = jnp.asarray(
        [o[0] * NY * NZ + o[1] * NZ + o[2]
         for o in np.asarray(CORNER_OFFSETS_S)], jnp.int32)

    def interp(a, x):
        # ntrpv: base = floor((x-plo)/dx - 0.5), clamped; trilinear weights
        xc = (x - plo_g) / dx - 0.5
        b = jnp.floor(xc).astype(jnp.int32)
        ok = jnp.all((b >= 0) & (b + 1 <= shape - 1), axis=-1)
        b = jnp.clip(b, 0, shape - 2)
        t = jnp.clip(xc - b, 0.0, 1.0)
        base = (b[:, 0] * NY + b[:, 1]) * NZ + b[:, 2]       # [ns]
        idx = base[:, None] + corner_off[None, :]            # [ns,8]
        c = a.reshape(a.shape[0], -1)[:, idx]                # [nf,ns,8]
        if c.dtype == jnp.bfloat16:  # bytes saved in the gather, math in f32
            c = c.astype(jnp.float32)
        tx, ty, tz = t[:, 0:1], t[:, 1:2], t[:, 2:3]
        wx = jnp.concatenate([1 - tx, tx], 1)                # [ns,2]
        wy = jnp.concatenate([1 - ty, ty], 1)
        wz = jnp.concatenate([1 - tz, tz], 1)
        offs = np.asarray(CORNER_OFFSETS_S)
        w = (wx[:, offs[:, 0]] * wy[:, offs[:, 1]] * wz[:, offs[:, 2]])
        v = jnp.einsum("fnc,nc->nf", c, w,
                       precision=jax.lax.Precision.HIGHEST)
        return v, ok

    def unit_vec(x):
        v, ok = interp(vec, x)
        # vnrml safe normalize (stream_nd.f90:208-225)
        n = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
        # guard must be representable in float32 (1e-300 underflows to 0)
        return direction * v / jnp.maximum(n, jnp.finfo(v.dtype).tiny), ok

    def step(carry, _):
        x, alive = carry
        k1, ok1 = unit_vec(x)
        k2, ok2 = unit_vec(x + 0.5 * h * k1)
        k3, ok3 = unit_vec(x + 0.5 * h * k2)
        k4, ok4 = unit_vec(x + h * k3)
        xn = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        ok = ok1 & ok2 & ok3 & ok4
        alive_n = alive & ok
        xn = jnp.where(alive_n[:, None], xn, x)  # freeze dead lines
        return (xn, alive_n), xn

    alive0 = jnp.ones(seeds.shape[0], dtype=bool)
    (_, alive), xs = jax.lax.scan(step, (seeds, alive0), None,
                                  length=n_steps)
    pos = jnp.concatenate([seeds[None], xs], axis=0)
    return pos, alive


@jax.jit
def _sample_fields(fields: jnp.ndarray, plo_g: jnp.ndarray, dx: jnp.ndarray,
                   pos: jnp.ndarray) -> jnp.ndarray:
    """Trilinear sample of all comps at path points (interpstream analog,
    sampleStreamlines_nd.f90:11-41).  pos [..., 3] -> [..., nf]."""
    shape = jnp.asarray(fields.shape[1:])
    xc = (pos - plo_g) / dx - 0.5
    b = jnp.floor(xc).astype(jnp.int32)
    b = jnp.clip(b, 0, shape - 2)
    t = jnp.clip(xc - b, 0.0, 1.0)
    i, j, k = b[..., 0], b[..., 1], b[..., 2]
    tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]

    def g(oi, oj, ok_):
        return jnp.moveaxis(fields[:, i + oi, j + oj, k + ok_], 0, -1)

    return ((1 - tx) * (1 - ty) * (1 - tz) * g(0, 0, 0)
            + tx * (1 - ty) * (1 - tz) * g(1, 0, 0)
            + (1 - tx) * ty * (1 - tz) * g(0, 1, 0)
            + tx * ty * (1 - tz) * g(1, 1, 0)
            + (1 - tx) * (1 - ty) * tz * g(0, 0, 1)
            + tx * (1 - ty) * tz * g(1, 0, 1)
            + (1 - tx) * ty * tz * g(0, 1, 1)
            + tx * ty * tz * g(1, 1, 1))


def _chunk_sizes(n, chunk):
    """March-chunk schedule for n seeds: full ``chunk``-sized chunks, then
    a halving tail (chunk/2 then chunk/4, last one padded).  The final
    chunk's fetch is the only one a later chunk's march can't overlap, so
    a small tail trims the exposed transfer; the fixed size classes keep
    the number of compiled march shapes bounded at 3."""
    sizes, rem = [], n
    while rem > chunk:
        sizes.append(chunk)
        rem -= chunk
    for c in (chunk // 2, chunk // 4):
        if c == 0:
            break
        while rem > c:
            sizes.append(c)
            rem -= c
    if rem > 0:
        sizes.append(max(chunk // 4, rem))
    return sizes


def trace_streamlines(
    dstate: DenseAmrState,
    seeds: np.ndarray,
    n_rk_steps: int,
    h_rk: float,
    trace_field: Optional[str] = None,
    sample_names: Sequence[str] = (),
    bc=None,
    march_dtype: Optional[str] = None,
    ngrow: Optional[int] = None,
    fetch_compress: Optional[bool] = None,
    defer: bool = False,
    march_chunk: Optional[int] = None,
) -> np.ndarray:
    """Trace ±nRKh RK4 steps from each seed; returns
    [nseed, 2*nRKh+1, 3 + len(sample_names)] with j=nRKh at the seed.

    march_chunk: split each level's seeds into fixed-size chunks so chunk
    i's host fetch (initiated with ``copy_to_host_async``) overlaps chunk
    i+1's device march.  The last chunk pads by repeating its tail seed so
    every chunk shares ONE compile; the duplicate rows decode into the same
    output slot.  Default: 2048 on non-CPU backends when a level marches
    >2048 seeds (0 disables).  ``defer=True`` ignores it — pipeline mode
    ships everything in one packed fetch instead.

    defer: queue the march and return a :class:`DeferredLines` instead of
    fetching — ``finish(extra=...)`` later makes ONE device-to-host copy of
    all levels' lines plus any chained device scalars (pipeline mode).

    trace_field: scalar whose (normalized) gradient is followed
    (grad-of-progress mode); None follows (x,y,z)_velocity.
    h_rk is in units of the finest dx (stream.cpp:700 hRK -> physical).
    march_dtype: precision of the traced vector field ONLY — bfloat16
    halves the bytes each RK4 corner gather moves.  Default is FULL input
    precision (the reference is double everywhere, stream_nd.f90); pass
    "bfloat16" to opt into the lossy march (max path deviation about 0.01
    finest cells on the bench surface — bench.py march_precision block).
    Positions and sampled outputs always stay in the input dtype.
    fetch_compress: ship positions as seed-f32 + int16 station DELTAS and
    reconstruct host-side — an RK4 station moves at most h_phys, so the
    quantization error is <= n_half*h/64000 ~ 4e-4*h at the default 51
    stations.  Halves the line-payload fetch.  LOSSY: written StreamData/Tecplot files carry the
    quantized stations and uint16 range-quantized sampled fields.
    Default: ON exactly when the march itself is lossy (bfloat16 default)
    AND the worst-case drift bound n_half*h/32000 stays below the bf16
    march deviation (n_half <= 320); long lines and full-precision marches
    ship exact f32.  (The default is the same in and out of pipeline mode
    on purpose: pipelined and file-chained runs are byte-parity-tested.)
    """
    meta = dstate.meta
    lmeta_cl = dstate.lmeta   # closures must not capture dstate (the
    #                           cross-instance cache would pin its data)
    # Precision default: FULL input precision (the reference is double
    # everywhere, stream_nd.f90:153-206).  bfloat16 field marching moves
    # fewer gathered bytes at a ~0.01-finest-cell path deviation — an
    # option that moves answers is OPT-IN (march_dtype="bfloat16").
    if march_dtype in ("float32", "float64", "none"):
        march_dtype = None
    # reference convention: nRKh = (nRKsteps-1)/2 (stream.cpp:701-702), so
    # StreamData written here has the same station count as reference files
    n_half = (n_rk_steps - 1) // 2
    # compressed line fetch: default exactly when the march is lossy anyway
    # AND the reconstruction drift bound (n_half quantization steps of
    # h/32000) stays below the bf16 march's ~0.01-cell path deviation
    compress = (march_dtype == "bfloat16" and n_half <= 320
                if fetch_compress is None else bool(fetch_compress))
    if n_rk_steps % 2 == 0:
        print(f"trace_streamlines: even nRKsteps={n_rk_steps} rounds to "
              f"{2 * n_half + 1} stations (reference nRKh=(nRKsteps-1)/2)")
    fin = meta.n_levels - 1
    h_phys = h_rk * meta.geoms[fin].dx[0]
    seeds = np.asarray(seeds, dtype=np.float64)
    if seeds.shape[1] == 2:  # DIM=2 plotfile: promote seeds to the z center
        g0 = meta.geoms[0]
        zc = 0.5 * (g0.prob_lo[2] + g0.prob_hi[2])
        seeds = np.concatenate(
            [seeds, np.full((len(seeds), 1), zc)], axis=1)
    seeds = push_nodes_inside(np.asarray(seeds, dtype=np.float64),
                              meta.geoms[0])
    owner = assign_seeds_to_levels(dstate, seeds)

    if trace_field is not None:
        vec_src = [trace_field]
    else:
        vec_src = ["x_velocity", "y_velocity", "z_velocity"]
        if "z_velocity" not in dstate.names:  # DIM=2 plotfile (promoted)
            vec_src = vec_src[:2]
    comps = [dstate.comp(n) for n in vec_src]
    scomps = [dstate.comp(n) for n in sample_names]
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]
    all_data = [d[np.asarray(comps + scomps)] for d in dstate.data]
    if trace_field is None and len(vec_src) == 2:
        # promote planar velocity with a zero z component
        import jax.numpy as _jnp
        all_data = [_jnp.concatenate(
            [d[:2], _jnp.zeros_like(d[:1]), d[2:]], axis=0)
            for d in all_data]
        vec_src = ["x_velocity", "y_velocity", "_zero"]

    nf = len(sample_names)
    out = np.zeros((len(seeds), 2 * n_half + 1, 3 + nf))
    pending = []   # (sel, result handle): dispatch every level FIRST so a
    #                level's device march overlaps the previous level's
    #                host fetch instead of serializing behind it
    for lev in range(meta.n_levels):
        sel = np.nonzero(owner == lev)[0]
        if len(sel) == 0:
            continue
        geom = meta.geoms[lev]
        dx = np.array(geom.dx)
        # nGrow default guarantees paths stay sampled (stream.cpp:705);
        # an explicit override trades memory for early-frozen lines, like
        # the reference's nGrow= key
        lev_ngrow = (ngrow if ngrow is not None
                     else int(np.ceil(h_phys * n_half / dx.min())) + 2)
        gbox = dstate.lmeta[lev].bbox.grow(lev_ngrow)
        plo_g = (np.array(geom.prob_lo)
                 + (np.array(gbox.lo) - np.array(geom.domain.lo)) * dx)
        nv = len(vec_src)

        # One jitted function per (level, ngrow, comp-count, mode): fill the
        # grow-region, build the traced vector field, march both directions,
        # sample — a single dispatch + a single fetch per level.
        cache = getattr(dstate, "_trace_fn_cache", None)
        if cache is None:
            cache = dstate._trace_fn_cache = {}
        # bc is closure-captured by the jitted fill: it MUST be in the key
        # (a second call with different bc would silently reuse the first's)
        key = (lev, lev_ngrow, all_data[0].shape[0], trace_field is not None,
               n_half, nf, march_dtype, repr(bc), compress)

        def make_engines(_lev, _g, _grad_mode, _plo_g, _dx):
            def prep(dl, ml):
                # fill + field layout run ONCE per level per call; chunked
                # marches reuse the result (prep moves the whole level
                # through device memory)
                grown = fill_dense_arrays(meta, lmeta_cl, dl, ml, _lev,
                                          _g, bc, "linear")
                if _grad_mode:
                    gx, gy, gz = centered_gradient(grown[0][None],
                                                   tuple(_dx), 1)
                    vec = jnp.concatenate([gx, gy, gz], axis=0)
                    fields = grown[nv:, 1:-1, 1:-1, 1:-1]
                else:
                    vec = grown[:3]
                    fields = grown[nv:]
                if march_dtype:
                    vec = vec.astype(march_dtype)
                return vec, fields

            def fn(vec, fields, sseeds, h):
                plo_np = (_plo_g + _dx if _grad_mode
                          else np.asarray(_plo_g))
                plo_v = jnp.asarray(plo_np)
                dxj = jnp.asarray(_dx)
                # march +/- as ONE scan over doubled seeds (per-seed
                # direction): halves the sequential gather chain, the
                # latency bottleneck of the RK4 loop
                ns = sseeds.shape[0]
                dirs = jnp.concatenate([jnp.ones(ns), -jnp.ones(ns)])
                pos2, _ = _trace_level(vec, fields, plo_v, dxj, h,
                                       jnp.concatenate([sseeds, sseeds]),
                                       n_half, dirs[:, None])
                pos_p, pos_m = pos2[:, :ns], pos2[:, ns:]
                path = jnp.concatenate([pos_m[::-1][:-1], pos_p], axis=0)
                path = jnp.transpose(path, (1, 0, 2))
                vals = (_sample_fields(fields, plo_v, dxj, path) if nf
                        else None)
                if compress:
                    # int16 station deltas (|delta| <= h_phys by the RK4
                    # normalized-step construction): half the fetch bytes.
                    # The SEED station ships exact; the host reconstructs
                    # outward from the center, so drift is <= n_half
                    # quantization steps (~2e-4 h), not 2*n_half.
                    # Everything packs into ONE int32 vector — a tuple
                    # fetch makes one device-to-host copy PER LEAF.
                    d = path[:, 1:] - path[:, :-1]
                    # scale by the TRACED step h (an argument), NOT the
                    # closure h_phys: a cached engine reused with a
                    # different hRK would otherwise decode with a
                    # mismatched scale (caught in r3 self-review)
                    # clamp: bf16 normalization rounding can overshoot h by
                    # ~1% (q ~ 32320); out-of-range f32->int16 is undefined
                    # in XLA and would silently corrupt reconstructed lines
                    q = jnp.clip(jnp.round(d * (32000.0 / h)),
                                 -32767.0, 32767.0).astype(jnp.int16)
                    qf = q.ravel()
                    if qf.size % 2:
                        qf = jnp.concatenate(
                            [qf, jnp.zeros(1, jnp.int16)])
                    parts = [jax.lax.bitcast_convert_type(
                                 path[:, n_half].astype(jnp.float32),
                                 jnp.int32).ravel(),
                             jax.lax.bitcast_convert_type(
                                 qf.reshape(-1, 2), jnp.int32).ravel()]
                    if nf:
                        # sampled fields quantize per line per comp to
                        # uint16 over the line's own range (error 1.5e-5
                        # of the range — below what the bf16 march's
                        # ~0.01-cell path deviation induces via the field
                        # gradient); (vmin, vmax) ship exact f32
                        v32 = vals.astype(jnp.float32)   # [ns, st, nf]
                        vmin = jnp.min(v32, axis=1)      # [ns, nf]
                        vmax = jnp.max(v32, axis=1)
                        rng = jnp.maximum(vmax - vmin, 1e-30)
                        vq = jnp.round(
                            (v32 - vmin[:, None]) / rng[:, None]
                            * 65535.0).astype(jnp.uint16)
                        vqf = vq.ravel()
                        if vqf.size % 2:
                            vqf = jnp.concatenate(
                                [vqf, jnp.zeros(1, jnp.uint16)])
                        parts.append(jax.lax.bitcast_convert_type(
                            jnp.stack([vmin, vmax], -1), jnp.int32).ravel())
                        parts.append(jax.lax.bitcast_convert_type(
                            vqf.reshape(-1, 2), jnp.int32).ravel())
                    return jnp.concatenate(parts)
                if nf:
                    return jnp.concatenate([path, vals], axis=-1)
                return path
            return jax.jit(prep), jax.jit(fn)

        if key not in cache:
            from ..amr.dense import shared_engine
            cache[key] = shared_engine(
                _GLOBAL_TRACE_FNS, 32, dstate, key,
                lambda: make_engines(lev, lev_ngrow, trace_field is not None,
                                     plo_g, dx))
        prep_fn, march_fn = cache[key]
        vecp, fieldsp = prep_fn(all_data, masks)
        chunk = march_chunk
        if chunk is None:
            chunk = (2048 if not defer and len(sel) > 2048
                     and jax.default_backend() != "cpu" else 0)
        if chunk and not defer and len(sel) > chunk:
            # descending tail schedule: the LAST chunk's fetch is the only
            # one not overlapped by a later chunk's march, so it ships the
            # smallest payload; pads duplicate the tail seed (duplicate
            # rows land in the same out slot), and the fixed size classes
            # (chunk, chunk/2, chunk/4) bound compiled march shapes at 3
            c0 = 0
            for sz in _chunk_sizes(len(sel), chunk):
                sc = sel[c0: c0 + sz]
                c0 += len(sc)
                if len(sc) < sz:
                    sc = np.concatenate(
                        [sc, np.full(sz - len(sc), sc[-1])])
                pending.append((sc, march_fn(vecp, fieldsp,
                                             jnp.asarray(seeds[sc]),
                                             h_phys)))
        else:
            pending.append((sel, march_fn(vecp, fieldsp,
                                          jnp.asarray(seeds[sel]),
                                          h_phys)))
    if defer:
        return DeferredLines(pending, out, compress, n_half, nf, h_phys)
    for _, res in pending:   # start every transfer before blocking on the
        try:                 # first: fetches ride behind the queued marches
            res.copy_to_host_async()
        except Exception:    # backend without async host copies
            pass
    for sel, res in pending:
        _decode_level(np.asarray(res), sel, out, compress, n_half, nf,
                      h_phys)
    return out


def _decode_level(packed, sel, out, compress, n_half, nf, h_phys):
    """Write one level's fetched line payload into out[sel]."""
    if not compress:
        ns2 = len(sel)
        st_n = 2 * n_half + 1
        out[sel] = packed.reshape(ns2, st_n, 3 + nf)
        return
    ns2 = len(sel)
    nq = ns2 * 2 * n_half * 3
    pc = packed[: ns2 * 3].view(np.float32).reshape(
        ns2, 3).astype(np.float64)
    q = packed[ns2 * 3: ns2 * 3 + (nq + 1) // 2].view(
        np.int16)[:nq].reshape(ns2, 2 * n_half, 3)
    d = q.astype(np.float64) * (h_phys / 32000.0)
    # stations ..n_half-1 | n_half (exact seed) | n_half+1..
    fwd = pc[:, None] + np.cumsum(d[:, n_half:], axis=1)
    bwd = pc[:, None] - np.cumsum(
        d[:, :n_half][:, ::-1], axis=1)[:, ::-1]
    out[sel, :, :3] = np.concatenate(
        [bwd, pc[:, None], fwd], axis=1)
    if nf:
        base = ns2 * 3 + (nq + 1) // 2
        st_n = 2 * n_half + 1
        mm = packed[base: base + ns2 * nf * 2].view(
            np.float32).reshape(ns2, nf, 2)
        base += ns2 * nf * 2
        nv = ns2 * st_n * nf
        vq = packed[base: base + (nv + 1) // 2].view(
            np.uint16)[:nv].reshape(ns2, st_n, nf)
        rngv = np.maximum(mm[:, :, 1] - mm[:, :, 0], 1e-30)
        out[sel, :, 3:] = (mm[:, None, :, 0]
                           + vq.astype(np.float64) / 65535.0
                           * rngv[:, None])


class DeferredLines:
    """Device-resident streamline payloads (pipeline mode).

    ``trace_streamlines(..., defer=True)`` queues the march and returns one
    of these instead of fetching: ``finish(extra=...)`` ships every level's
    line payload PLUS any caller-supplied device arrays in ONE packed int32
    vector — one device-to-host copy for the whole chain tail, instead of
    one per level plus one per extra.  The reference gets this for free by never leaving host
    memory between stages (/root/reference/Src/GNUmakefile:14-40)."""

    def __init__(self, pending, out, compress, n_half, nf, h_phys):
        self._pending = pending        # [(sel, device result), ...]
        self._out = out
        self._compress = compress
        self._n_half = n_half
        self._nf = nf
        self._h_phys = h_phys
        self._done = False

    @staticmethod
    def _as_words(arr):
        """Bitcast any device array to a flat int32 word vector."""
        if arr.dtype == jnp.int32:
            return arr.ravel()
        a = arr.astype(jnp.float32) if arr.dtype not in (
            jnp.float32, jnp.float64) else arr
        return jax.lax.bitcast_convert_type(a, jnp.int32).ravel()

    def finish(self, extra=()):
        """(lines, extra_host): ONE packed fetch of all levels + extras.
        ``extra``: device arrays (float or int32); returned as numpy arrays
        of the original shapes (f64 stays f64, other floats come back f32,
        int32 stays int32 — mirrors ``_as_words``)."""
        if self._done:
            raise RuntimeError("DeferredLines.finish() already consumed")
        self._done = True
        lvl_words = [self._as_words(res) for _, res in self._pending]
        ex_words = [self._as_words(e) for e in extra]
        ex_shapes = [tuple(e.shape) for e in extra]
        ex_dtypes = [np.int32 if e.dtype == jnp.int32
                     else np.float64 if e.dtype == jnp.float64
                     else np.float32 for e in extra]
        allw = lvl_words + ex_words
        if not allw:                  # zero seeds, zero extras
            return self._out, []
        vec = allw[0] if len(allw) == 1 else jnp.concatenate(allw)
        host = np.asarray(vec)
        p = 0
        for (sel, res), w in zip(self._pending, lvl_words):
            seg = host[p: p + w.size]
            p += w.size
            if not self._compress:
                dt = np.float64 if res.dtype == jnp.float64 else np.float32
                seg = seg.view(dt)
            _decode_level(seg, sel, self._out, self._compress,
                          self._n_half, self._nf, self._h_phys)
        extras = []
        for w, shp, dt in zip(ex_words, ex_shapes, ex_dtypes):
            seg = host[p: p + w.size]
            p += w.size
            extras.append(seg.reshape(shp) if dt == np.int32
                          else seg.view(dt).reshape(shp))
        return self._out, extras


def seed_rake(lo, hi, n: int) -> np.ndarray:
    """n seeds on the segment lo..hi (seedRake, stream.cpp:506-532)."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    t = np.linspace(0.0, 1.0, n)[:, None]
    return lo[None] + t * (hi - lo)[None]


def trace_streamlines_sparse(
    state,
    seeds: np.ndarray,
    n_rk_steps: int,
    h_rk: float,
    trace_field: Optional[str] = None,
    sample_names: Sequence[str] = (),
    bc=None,
    march_dtype: Optional[str] = None,
    ngrow: Optional[int] = None,
    fetch_compress: Optional[bool] = None,
) -> np.ndarray:
    """Sparse-refinement trace: the finest level is processed as dense
    CLUSTERS (amr/cluster.py) so HBM scales with cluster bboxes instead of
    the union bbox.  Seeds are partitioned GLOBALLY (owner level from the
    full BoxArrays, owner cluster for finest-owned seeds); clusters are
    separated by the full grow radius, so each per-cluster march samples
    exactly what the union-bbox march would.  Coarse-owned seeds trace on
    the shared coarse arrays (identical in every substate).

    `state` is the batched AmrState; output layout matches
    trace_streamlines."""
    from ..amr.canonical import (canonical_cluster_substates,
                                 coarse_only_state)
    from ..amr.dense import DenseAmrState

    meta = state.meta
    fin = meta.n_levels - 1
    n_half = (n_rk_steps - 1) // 2
    h_phys = h_rk * meta.geoms[fin].dx[0]
    # grow radius of the finest level's march — clusters must be separated
    # by at least this much for the per-cluster fill to be exact
    ngrow_fin = (ngrow if ngrow is not None
                 else int(np.ceil(h_phys * n_half
                                  / min(meta.geoms[fin].dx))) + 2)
    # canonical frames (amr/canonical.py): equal-bucket clusters share ONE
    # compiled march+prep engine — the per-cluster absolute positions used
    # to force a compile per cluster (the r4 iso/grad/curvature fix, here
    # for the march).  Window margins carry the FULL march grow radius;
    # boundary-near clusters come back as legacy global-coarse substates
    # (infos[i].canonical False) and march exactly as before.
    groups, subs, base, infos = canonical_cluster_substates(
        state, ngrow_max=ngrow_fin, interp_stencil=1, dist=ngrow_fin + 1)

    seeds = np.asarray(seeds, np.float64)
    if seeds.shape[1] == 2:  # DIM=2 plotfile: promote seeds to the z center
        g0 = meta.geoms[0]
        zc = 0.5 * (g0.prob_lo[2] + g0.prob_hi[2])
        seeds = np.concatenate(
            [seeds, np.full((len(seeds), 1), zc)], axis=1)
    seeds = push_nodes_inside(seeds, meta.geoms[0])
    # global owner level for each seed, finest checked against the real
    # BoxArray (no dense union mask needed)
    geom_f = meta.geoms[fin]
    dxf = np.array(geom_f.dx)
    idxf = np.floor((seeds - np.array(geom_f.prob_lo)) / dxf).astype(
        np.int64) + np.array(geom_f.domain.lo)
    on_fine = np.zeros(len(seeds), bool)
    cluster_of = np.full(len(seeds), -1, np.int64)
    boxes = list(meta.bas[fin])
    for gi, g in enumerate(groups):
        for i in g:
            b = boxes[i]
            inb = np.all((idxf >= np.array(b.lo))
                         & (idxf <= np.array(b.hi)), axis=1)
            on_fine |= inb
            cluster_of[inb] = gi

    nf = len(sample_names)
    out = np.zeros((len(seeds), 2 * n_half + 1, 3 + nf))
    kw = dict(trace_field=trace_field, sample_names=sample_names, bc=bc,
              march_dtype=march_dtype, ngrow=ngrow,
              fetch_compress=fetch_compress)
    coarse_sel = np.nonzero(~on_fine)[0]
    jobs = []
    if len(coarse_sel):
        jobs.append((-1, coarse_sel))
    for gi in range(len(groups)):
        sel = np.nonzero(cluster_of == gi)[0]
        if len(sel):
            jobs.append((gi, sel))
    # coarse-owned seeds march on the GLOBAL coarse-only hierarchy: its
    # engine fingerprint is cluster-independent (a canonical sub's coarse
    # windows are crops and cannot host far-away seeds)
    cds = None
    h_rk_c = h_rk
    if len(coarse_sel):
        # (fin==0 keeps the legacy behavior: substates carry global data)
        cds = coarse_only_state(state, base) if fin > 0 else subs[0]
        # h_rk is in units of the state's FINEST dx (stream.cpp:700): the
        # coarse-only hierarchy's finest level is coarser, so rescale to
        # keep the physical step identical
        h_rk_c = (h_rk * meta.geoms[fin].dx[0]
                  / cds.meta.geoms[cds.meta.n_levels - 1].dx[0])
    plo_f = np.array(meta.geoms[fin].prob_lo)
    dom_f_lo = np.array(meta.geoms[fin].domain.lo)

    # per-cluster marches run threaded so their engine compiles overlap
    from concurrent.futures import ThreadPoolExecutor

    def _pad_pow2(s):
        """Canonical clusters share field shapes, but a per-cluster seed
        COUNT is also a compile shape — pad to a power-of-two bucket
        (repeating the last seed; duplicates are computed then sliced off)
        so equal-bucket clusters share ONE march compile regardless of how
        the seeds scatter."""
        n = len(s)
        m = 1 << max(6, int(np.ceil(np.log2(n))))
        if m > n:
            s = np.concatenate([s, np.repeat(s[-1:], m - n, axis=0)])
        return s, n

    def run_one(job):
        gi, sel = job
        if gi == -1:
            return sel, trace_streamlines(cds, seeds[sel], n_rk_steps,
                                          h_rk_c, **kw)
        info = infos[gi]
        if not info.canonical:
            return sel, trace_streamlines(subs[gi], seeds[sel], n_rk_steps,
                                          h_rk, **kw)
        # canonical frame: seeds translate into window-local physical
        # coordinates, line positions translate back; sampled fields are
        # translation-invariant.  General map (holds for interior AND
        # boundary-pinned signatures, where prob_lo anchors the pinned
        # domain inside the window): x_local = plo_c + (j - dom_c.lo)*dx,
        # x_global = plo + (j + shift - dom.lo)*dx for canonical index j.
        geom_c = subs[gi].meta.geoms[fin]
        dom_c_lo = np.array(geom_c.domain.lo)
        off = (plo_f - np.array(geom_c.prob_lo)
               + (info.shift - dom_f_lo + dom_c_lo) * dxf)
        s_pad, n_sel = _pad_pow2(seeds[sel] - off)
        lines = trace_streamlines(subs[gi], s_pad, n_rk_steps,
                                  h_rk, **kw)[:n_sel]
        lines[:, :, :3] += off
        return sel, lines

    with ThreadPoolExecutor(max_workers=min(max(len(jobs), 1), 8)) as ex:
        for sel, lines in ex.map(run_one, jobs):
            out[sel] = lines
    return out
