"""Masked, weighted binning primitives — the device-side replacement for the
reference's per-cell binning loops (+MPI reductions) in conditionalMean /
jpdf / integral (/root/reference/Src/conditionalMean.cpp:260-303,
Src/jpdf.cpp:427-537).

Histograms here are **one-hot contractions** instead of scatter-adds
(`.at[].add`): per chunk of C cells, a [nbins, C] @ [C, ...] matmul
accumulates counts / sums / joint bins (the 2-D pdf is literally
onehot1.T @ (w * onehot2)).  Every contraction asks for
``Precision.HIGHEST``: a float32 matmul may otherwise run in TF32 on the
GPU's tensor cores, which keeps about three digits of the moments.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

_CHUNK = 1 << 16
_HIGHEST = jax.lax.Precision.HIGHEST


def _pad_flat(x: jnp.ndarray, fill) -> Tuple[jnp.ndarray, int]:
    n = x.size
    m = ((n + _CHUNK - 1) // _CHUNK) * _CHUNK
    return jnp.pad(x.reshape(-1), (0, m - n),
                   constant_values=fill).reshape(-1, _CHUNK), n


@partial(jax.jit, static_argnames=("nbins", "clamp", "with_minmax"))
def binned_stats(bin_vals: jnp.ndarray, avg_vals: jnp.ndarray,
                 weight: jnp.ndarray, mask: jnp.ndarray,
                 bmin: float, bmax: float, nbins: int,
                 clamp: bool = False, with_minmax: bool = False,
                 shift: Optional[jnp.ndarray] = None):
    """1-D conditional binning (conditionalMean semantics).

    bin_vals: [*shape]; avg_vals: [ncomp, *shape]; weight: scalar or [*shape];
    mask: bool [*shape].  Out-of-range cells are dropped (clamp=False,
    conditionalMean.cpp:270-275) or clamped to edge bins (jpdf semantics).
    Returns (hits[nbins], sums[nbins,ncomp], sumsq[nbins,ncomp], mins, maxs).

    ``shift`` ([ncomp], optional): per-component offsets subtracted from the
    values before the sum/sumsq contractions.  The reference accumulates in
    double (conditionalMean.cpp uses Real=double); device compute is float32, so
    raw sumsq of a field like temp (~2000 K) keeps only ~7 digits and
    ``sumsq/hits - mean^2`` cancels catastrophically.  With shift ≈ mean the
    shifted moments are small-magnitude and the variance survives float32;
    callers reconstruct the raw columns on host in float64 (see
    ``reconstruct_moments``).  min/max are of the UNshifted values.
    """
    ncomp = avg_vals.shape[0]
    dt = avg_vals.dtype
    x = (bin_vals - bmin) / (bmax - bmin) * nbins
    idx = jnp.floor(x).astype(jnp.int32)
    if clamp:
        ok = mask
        idx = jnp.clip(idx, 0, nbins - 1)
    else:
        ok = mask & (idx >= 0) & (idx < nbins)
        idx = jnp.clip(idx, 0, nbins - 1)
    w = jnp.where(ok, jnp.broadcast_to(weight, bin_vals.shape), 0.0)

    idx_c, n = _pad_flat(idx, 0)
    w_c, _ = _pad_flat(w.astype(dt), 0.0)
    v_c = jnp.stack([_pad_flat(avg_vals[k].astype(dt), 0.0)[0]
                     for k in range(ncomp)], axis=-1)   # [nc, C, ncomp]
    ok_c, _ = _pad_flat(ok, False)
    big = jnp.asarray(jnp.inf, dt)
    sh = (jnp.zeros((ncomp,), dt) if shift is None
          else jnp.asarray(shift, dt))

    bins = jnp.arange(nbins, dtype=jnp.int32)

    def body(carry, args):
        hits, sums, sumsq, mins, maxs = carry
        ic, wc, vc, okc = args
        vs = vc - sh[None, :]
        onehot = (ic[:, None] == bins[None, :]).astype(dt)   # [C, nbins]
        oww = onehot * wc[:, None]
        # ONE [nbins,C]@[C,1+2k] matmul for hits+sums+sumsq: the onehot is
        # read from device memory once instead of three times
        rhs = jnp.concatenate(
            [jnp.ones((vs.shape[0], 1), dt), vs, vs * vs], axis=1)
        out = jnp.einsum("cb,cr->br", oww, rhs, preferred_element_type=dt,
                         precision=_HIGHEST)
        hits = hits + out[:, 0]
        sums = sums + out[:, 1:1 + ncomp]
        sumsq = sumsq + out[:, 1 + ncomp:]
        if with_minmax:
            sel = onehot.astype(bool) & okc[:, None]
            for_min = jnp.where(sel[:, :, None], vc[:, None, :], big)
            for_max = jnp.where(sel[:, :, None], vc[:, None, :], -big)
            mins = jnp.minimum(mins, jnp.min(for_min, axis=0))
            maxs = jnp.maximum(maxs, jnp.max(for_max, axis=0))
        return (hits, sums, sumsq, mins, maxs), None

    init = (jnp.zeros(nbins, dt), jnp.zeros((nbins, ncomp), dt),
            jnp.zeros((nbins, ncomp), dt),
            jnp.full((nbins, ncomp), big),
            jnp.full((nbins, ncomp), -big))
    (hits, sums, sumsq, mins, maxs), _ = jax.lax.scan(
        body, init, (idx_c, w_c, v_c, ok_c))
    if not with_minmax:
        mins = maxs = None
    return hits, sums, sumsq, mins, maxs


def masked_mean(vals: jnp.ndarray, mask: jnp.ndarray, weight) -> jnp.ndarray:
    """Weighted masked mean — used as the moment shift (see binned_stats)."""
    w = jnp.where(mask, jnp.broadcast_to(weight, vals.shape), 0.0)
    den = jnp.sum(w)
    # 1e-300 underflows to 0.0 in float32 (all-masked input -> NaN shift)
    tiny = 1e-30 if jnp.result_type(den) == jnp.float32 else 1e-300
    return jnp.sum(w * vals) / jnp.maximum(den, tiny)


def reconstruct_moments(hits, sums_s, sumsq_s, shift):
    """Host-side (numpy float64) reconstruction of raw moments from shifted
    ones: sum = sum' + c*hits; sumsq = sumsq' + 2c*sum' + c^2*hits.  Done in
    float64 so the c^2*hits term cancels exactly when a consumer later forms
    ``var = sumsq/hits - mean^2`` (the reference's double-accumulation
    semantics, conditionalMean.cpp:260-303, restored without float64 device
    contractions).  hits: [nbins]; sums_s/sumsq_s: [nbins, ncomp];
    shift: [ncomp].  Returns float64 (sums, sumsq)."""
    import numpy as np
    h = np.asarray(hits, np.float64)
    s = np.asarray(sums_s, np.float64)
    q = np.asarray(sumsq_s, np.float64)
    c = np.asarray(shift, np.float64)
    sums = s + c[None, :] * h[:, None]
    sumsq = q + 2.0 * c[None, :] * s + (c * c)[None, :] * h[:, None]
    return sums, sumsq


@partial(jax.jit, static_argnames=("nbins",))
def joint_pdf(v1: jnp.ndarray, v2: jnp.ndarray, vol: jnp.ndarray,
              mask: jnp.ndarray,
              v1min: float, v1max: float, v2min: float, v2max: float,
              nbins: int,
              shift1=None, shift2=None):
    """2-D volume-weighted joint histogram (jpdf semantics: out-of-range
    values clamp into edge bins, jpdf.cpp:489-496) as chunked one-hot
    matmuls: bin += onehot1.T @ (w * onehot2).
    Returns (bin, binX1, binX2) each [nbins, nbins] row-major [v1, v2].
    With shift1/shift2 the X1/X2 accumulators hold (v - shift) sums; the
    caller reconstructs binX = binX' + shift*bin on host (float32-safe
    accumulation, same rationale as binned_stats)."""
    dt = jnp.result_type(v1.dtype, jnp.float32)
    i1 = jnp.clip(jnp.floor((v1 - v1min) / (v1max - v1min) * nbins)
                  .astype(jnp.int32), 0, nbins - 1)
    i2 = jnp.clip(jnp.floor((v2 - v2min) / (v2max - v2min) * nbins)
                  .astype(jnp.int32), 0, nbins - 1)
    w = jnp.where(mask, jnp.broadcast_to(vol, v1.shape), 0.0).astype(dt)
    c1 = jnp.asarray(0.0 if shift1 is None else shift1, dt)
    c2 = jnp.asarray(0.0 if shift2 is None else shift2, dt)

    i1c, _ = _pad_flat(i1, 0)
    i2c, _ = _pad_flat(i2, 0)
    wc, _ = _pad_flat(w, 0.0)
    v1c, _ = _pad_flat((v1.astype(dt) - c1), 0.0)
    v2c, _ = _pad_flat((v2.astype(dt) - c2), 0.0)
    bins = jnp.arange(nbins, dtype=jnp.int32)

    def body(carry, args):
        acc = carry
        a1, a2, ww, f1, f2 = args
        o1 = (a1[:, None] == bins[None, :]).astype(dt)      # [C, n]
        o2 = (a2[:, None] == bins[None, :]).astype(dt)
        o1w = o1 * ww[:, None]
        # ONE batched [3] x [n,C]@[C,n] dot: o2 is read once per chunk
        lhs = jnp.stack([o1w, o1w * f1[:, None], o1w * f2[:, None]])
        acc = acc + jnp.einsum("xcb,cd->xbd", lhs, o2,
                               preferred_element_type=dt,
                               precision=_HIGHEST)
        return acc, None

    init = jnp.zeros((3, nbins, nbins), dt)
    acc, _ = jax.lax.scan(body, init, (i1c, i2c, wc, v1c, v2c))
    return acc[0], acc[1], acc[2]


@partial(jax.jit, static_argnames=("nbins", "pairs"))
def joint_pdf_multi(vals: jnp.ndarray, vol, mask: jnp.ndarray,
                    lo: jnp.ndarray, hi: jnp.ndarray, nbins: int,
                    pairs: Tuple[Tuple[int, int], ...],
                    shifts: Optional[jnp.ndarray] = None):
    """All-pairs joint histograms sharing per-variable one-hots (the jpdf
    tool computes n(n-1)/2 pairs over the SAME cells, jpdf.cpp:427-525; building each variable's one-hot once and
    contracting all pairs in one batched dot amortizes the one-hot
    construction/memory traffic nv(nv-1)/2-fold and replaces per-pair
    dispatch+fetch with a single call).

    vals: [nv, *shape]; vol: scalar or [*shape]; mask: bool [*shape];
    lo/hi/shifts: [nv]; pairs: STATIC tuple of (i, j) var-index pairs.
    Returns (b, bx1, bx2) each [npairs, nbins, nbins] row-major [vi, vj],
    jpdf edge-bin clamp semantics; bx accumulators hold shifted sums (the
    caller reconstructs binX = binX' + shift*b on host, as joint_pdf).
    """
    nv = vals.shape[0]
    P = len(pairs)
    dt = jnp.result_type(vals.dtype, jnp.float32)
    if P == 0:
        z = jnp.zeros((0, nbins, nbins), dt)
        return z, z, z
    sh = (jnp.zeros((nv,), dt) if shifts is None
          else jnp.asarray(shifts, dt))
    lo = jnp.asarray(lo, dt)
    hi = jnp.asarray(hi, dt)
    flat = vals.reshape(nv, -1).astype(dt)
    idx = jnp.clip(jnp.floor((flat - lo[:, None]) / (hi - lo)[:, None]
                             * nbins).astype(jnp.int32), 0, nbins - 1)
    w = jnp.where(mask, jnp.broadcast_to(vol, mask.shape), 0.0) \
        .astype(dt).reshape(-1)
    fs = flat - sh[:, None]

    # 16k-cell chunks: the smaller one-hot slabs are reused across the
    # per-pair dots
    chunk = 16384
    n = w.size
    m = ((n + chunk - 1) // chunk) * chunk
    pad = m - n
    idx_c = jnp.pad(idx, ((0, 0), (0, pad))).reshape(nv, -1, chunk) \
        .transpose(1, 0, 2)                                  # [nc, nv, C]
    w_c = jnp.pad(w, (0, pad)).reshape(-1, chunk)            # [nc, C]
    f_c = jnp.pad(fs, ((0, 0), (0, pad))).reshape(nv, -1, chunk) \
        .transpose(1, 0, 2)
    bins = jnp.arange(nbins, dtype=jnp.int32)

    def body(acc, args):
        ic, wc, fc = args                                    # [nv,C],[C],[nv,C]
        oh = (ic[:, :, None] == bins[None, None, :]).astype(dt)  # [nv,C,n]
        ow = oh * wc[None, :, None]
        # per-pair batched-3 dots reusing the shared one-hots (one
        # [3,P,C,n]-stacked einsum would materialize the stack in device
        # memory; the loop is static — P dots fused by XLA)
        outs = []
        for i, j in pairs:
            lhs = jnp.stack([ow[i], ow[i] * fc[i][:, None],
                             ow[i] * fc[j][:, None]])        # [3,C,n]
            outs.append(jnp.einsum("xcb,cd->xbd", lhs, oh[j],
                                   preferred_element_type=dt,
                                   precision=_HIGHEST))
        acc = acc + jnp.stack(outs, axis=1)                  # [3,P,n,n]
        return acc, None

    init = jnp.zeros((3, P, nbins, nbins), dt)
    acc, _ = jax.lax.scan(body, init, (idx_c, w_c, f_c))
    return acc[0], acc[1], acc[2]


def masked_sum(vals: jnp.ndarray, mask: jnp.ndarray,
               weight) -> jnp.ndarray:
    return jnp.sum(jnp.where(mask, vals, 0.0) * weight)


@partial(jax.jit, static_argnames=("axes",))
def directional_sum(vals: jnp.ndarray, mask: jnp.ndarray, weight,
                    axes: Tuple[int, ...]) -> jnp.ndarray:
    """Sum value*weight over masked cells along the given spatial axes
    (integral's integrate1d analog, Src/integral.cpp:13-60)."""
    return jnp.sum(jnp.where(mask, vals, 0.0) * weight, axis=axes)
