"""Pure-numpy float64 reference implementations (CPU baseline + parity
oracle).

These mirror the reference's CPU numerics (centered-difference gradients on
ghost-filled data, /root/reference/Src/grad.cpp:211-235) and serve two roles:
the parity oracle for tests and the single-process CPU baseline that bench.py
compares the device pipeline against.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def numpy_apply_fill(plan, fine: np.ndarray,
                     crse: Optional[np.ndarray] = None) -> np.ndarray:
    """Numpy mirror of ops.fill.apply_fill (same gather plan)."""
    same_src = np.asarray(plan.same_src)
    nbox, ncomp = fine.shape[0], fine.shape[1]
    fine_flat = np.moveaxis(fine, 1, 0).reshape(ncomp, -1)
    vals = fine_flat[:, same_src.reshape(-1)].reshape(
        (ncomp, nbox) + plan.grown_shape)
    if plan.crse_src is not None:
        crse_flat = np.moveaxis(crse, 1, 0).reshape(ncomp, -1)
        crse_src = np.asarray(plan.crse_src)
        use = np.asarray(plan.use_crse)
        if plan.crse_wt is None:
            cvals = crse_flat[:, crse_src.reshape(-1)].reshape(
                (ncomp, nbox) + plan.grown_shape)
        else:
            wt = np.asarray(plan.crse_wt, dtype=fine.dtype)
            cvals = 0.0
            for k in range(crse_src.shape[-1]):
                g = crse_flat[:, crse_src[..., k].reshape(-1)].reshape(
                    (ncomp, nbox) + plan.grown_shape)
                cvals = cvals + g * wt[..., k]
        vals = np.where(use[None], cvals, vals)
    if plan.sign is not None:
        vals = vals * np.asarray(plan.sign, dtype=fine.dtype)[None]
    return np.moveaxis(vals, 0, 1)


def numpy_centered_gradient(grown: np.ndarray, dx: Sequence[float]):
    g = grown
    c = (slice(None),) * (g.ndim - 3)
    i = slice(1, -1)
    gx = (g[c + (slice(2, None), i, i)] - g[c + (slice(0, -2), i, i)]) / (2 * dx[0])
    gy = (g[c + (i, slice(2, None), i)] - g[c + (i, slice(0, -2), i)]) / (2 * dx[1])
    gz = (g[c + (i, i, slice(2, None))] - g[c + (i, i, slice(0, -2))]) / (2 * dx[2])
    return gx, gy, gz


def numpy_grad_level(plan, data: np.ndarray, crse: Optional[np.ndarray],
                     dx) -> np.ndarray:
    grown = numpy_apply_fill(plan, data, crse)
    gx, gy, gz = numpy_centered_gradient(grown, dx)
    mag = np.sqrt(gx * gx + gy * gy + gz * gz)
    return np.concatenate([gx, gy, gz, mag], axis=1)


def numpy_multilevel_grad(plans, fields, dxs):
    """Per-level gradients of a multi-level scalar, coarse-fine ghosts from
    the coarser level of the same field (curvature's derived-field pattern)."""
    grads = []
    for lev, f in enumerate(fields):
        crse = fields[lev - 1] if lev > 0 else None
        grown = numpy_apply_fill(plans[lev], f, crse)
        grads.append(numpy_centered_gradient(grown, dxs[lev]))
    return grads


def numpy_curvature(plans, prog_levels, dxs):
    """CPU mirror of the curvature pipeline numerics (mean + Gaussian
    curvature of a progress field; /root/reference/Src/curvature.cpp flow):
    gradient, flame normal, div(normal), grad-of-grad Hessian, adjugate."""
    n_lev = len(prog_levels)
    g = numpy_multilevel_grad(plans, prog_levels, dxs)
    G = [np.concatenate(g[lev], axis=1) for lev in range(n_lev)]
    normg = [-np.maximum(1e-14, np.sqrt((G[lev] ** 2).sum(axis=1,
                                                          keepdims=True)))
             for lev in range(n_lev)]
    N = [G[lev] / normg[lev] for lev in range(n_lev)]
    out = []
    for lev in range(n_lev):
        div = 0.0
        for d in range(3):
            comp = [N[l][:, d : d + 1] for l in range(n_lev)]
            gl = numpy_multilevel_grad(plans, comp, dxs)
            div = div + gl[lev][d]
        Km = 0.5 * div
        H = []
        for i in range(3):
            comp = [G[l][:, i : i + 1] for l in range(n_lev)]
            gl = numpy_multilevel_grad(plans, comp, dxs)
            H.append([gl[lev][j][:, 0] for j in range(3)])
        adj = [[H[(i + 1) % 3][(j + 1) % 3] * H[(i + 2) % 3][(j + 2) % 3]
                - H[(i + 1) % 3][(j + 2) % 3] * H[(i + 2) % 3][(j + 1) % 3]
                for j in range(3)] for i in range(3)]
        Gl = G[lev]
        num = 0.0
        for i in range(3):
            for j in range(3):
                num = num + Gl[:, i] * adj[i][j] * Gl[:, j]
        Kg = num / normg[lev][:, 0] ** 4
        out.append((Km, Kg))
    return out


def numpy_trace(field, plo, dxs, seeds, n_half, h):
    """RK4 streamline march of stream/trace.py in float64 numpy: each stage
    samples ``field`` [3, X, Y, Z] trilinearly on the cell-centred dual grid
    (ntrpv: base = floor((x - plo)/dx - 0.5), clamped) and normalizes the
    vector, so ``h`` is arclength.  Returns [n_half + 1, nseed, 3] for the
    +direction march (station 0 at the seed)."""
    field = np.asarray(field, np.float64)
    plo = np.asarray(plo, np.float64)
    dxs = np.asarray(dxs, np.float64)
    pos = np.asarray(seeds, np.float64).copy()
    out = [pos.copy()]

    def unit(x):
        xc = (x - plo) / dxs - 0.5
        b = np.clip(np.floor(xc).astype(int), 0,
                    np.array(field.shape[1:]) - 2)
        t = np.clip(xc - b, 0, 1)
        i, j, k = b[:, 0], b[:, 1], b[:, 2]
        v = 0
        for oi in (0, 1):
            for oj in (0, 1):
                for ok in (0, 1):
                    w = (np.where(oi, t[:, 0], 1 - t[:, 0])
                         * np.where(oj, t[:, 1], 1 - t[:, 1])
                         * np.where(ok, t[:, 2], 1 - t[:, 2]))
                    v = v + w[:, None] * field[:, i + oi, j + oj, k + ok].T
        return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True),
                              1e-300)

    for _ in range(n_half):
        k1 = unit(pos)
        k2 = unit(pos + 0.5 * h * k1)
        k3 = unit(pos + 0.5 * h * k2)
        k4 = unit(pos + h * k3)
        pos = pos + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(pos.copy())
    return np.stack(out)


def numpy_binned_stats(bin_vals, avg_vals, weight, mask, bmin, bmax, nbins):
    """``np.add.at`` oracle of ops.stats.binned_stats with conditionalMean
    semantics (out-of-range cells dropped): bin_vals [*shape], avg_vals
    [ncomp, *shape], weight scalar or [*shape], mask bool [*shape].
    Returns float64 (hits [nbins], sums [nbins, ncomp], sumsq)."""
    x = np.asarray(bin_vals, np.float64)
    idx = np.floor((x - bmin) / (bmax - bmin) * nbins).astype(np.int64)
    ok = np.asarray(mask, bool) & (idx >= 0) & (idx < nbins)
    w = np.broadcast_to(np.asarray(weight, np.float64), x.shape)[ok]
    i = idx[ok]
    v = np.asarray(avg_vals, np.float64)[:, ok]
    hits = np.zeros(nbins)
    np.add.at(hits, i, w)
    sums = np.zeros((nbins, v.shape[0]))
    sumsq = np.zeros((nbins, v.shape[0]))
    for k in range(v.shape[0]):
        np.add.at(sums[:, k], i, w * v[k])
        np.add.at(sumsq[:, k], i, w * v[k] ** 2)
    return hits, sums, sumsq


def numpy_joint_pdf(v1, v2, vol, mask, v1min, v1max, v2min, v2max, nbins):
    """``np.add.at`` oracle of ops.stats.joint_pdf (jpdf semantics:
    out-of-range values clamp into the edge bins).  Returns float64
    (bin, binX1, binX2), each [nbins, nbins] indexed [v1, v2]."""
    a = np.asarray(v1, np.float64)
    b = np.asarray(v2, np.float64)
    i1 = np.clip(np.floor((a - v1min) / (v1max - v1min) * nbins)
                 .astype(np.int64), 0, nbins - 1)
    i2 = np.clip(np.floor((b - v2min) / (v2max - v2min) * nbins)
                 .astype(np.int64), 0, nbins - 1)
    m = np.asarray(mask, bool)
    w = np.broadcast_to(np.asarray(vol, np.float64), a.shape)[m]
    flat = i1[m] * nbins + i2[m]
    out = []
    for val in (1.0, a[m], b[m]):
        acc = np.zeros(nbins * nbins)
        np.add.at(acc, flat, w * val)
        out.append(acc.reshape(nbins, nbins))
    return tuple(out)
