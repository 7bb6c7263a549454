"""Benchmark: the BASELINE.json composite — grad + curvature + isosurface on
a 3-level synthetic Pele-style plotfile, on one GPU (jax float32, dense
canonical levels), against the CPU reference numerics (numpy float64,
single process — one rank of the reference's MPI build).

Run: ``python bench.py`` on a machine with a GPU.  It fails, and prints no
result, where JAX finds no GPU.  It prints the card's name and power limit
first, then ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
value = GPU composite wall-clock (ms); vs_baseline = cpu_ms / gpu_ms, where
cpu_ms comes from the PINNED oracle timings in BASELINE_CPU.json
(PELE_BENCH_LIVE_CPU=1 re-measures them — detail.cpu_source says which was
used).

Every section after the core composite is optional and budget-guarded;
partial results checkpoint to BENCH_PARTIAL.json after each section; a
watchdog thread emits the summary line and exits 0 when
PELE_BENCH_BUDGET_S (default 780 s) expires, and SIGTERM does the same.

Timing: device phases are K-step on-device dependency chains ended by
``block_until_ready``; the isosurface is timed end-to-end (device classify
+ host compaction), like a user running the tool.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time

import numpy as np

_T_START = time.perf_counter()
BUDGET_S = float(os.environ.get("PELE_BENCH_BUDGET_S", "780"))
_LOCK = threading.Lock()
_EMITTED = False
RESULT = {
    "metric": "grad_curv_iso_3level_ms",
    "value": None,
    "unit": "ms",
    "vs_baseline": None,
    "detail": {"sections": {}},
}
DETAIL = RESULT["detail"]


def _elapsed() -> float:
    return time.perf_counter() - _T_START


def _remaining() -> float:
    return BUDGET_S - _elapsed()


def _save_partial() -> None:
    try:
        tmp = "BENCH_PARTIAL.json.tmp"
        with open(tmp, "w") as f:
            json.dump(RESULT, f, indent=1)
        os.replace(tmp, "BENCH_PARTIAL.json")
    except Exception:
        pass


def _emit() -> None:
    """Print the single summary JSON line exactly once, from whatever has
    completed (value stays null when the core composite did not finish)."""
    global _EMITTED
    with _LOCK:
        if _EMITTED:
            return
        _EMITTED = True
        DETAIL["bench_elapsed_s"] = round(_elapsed(), 1)
        print(json.dumps(RESULT), flush=True)
        _save_partial()


def _watchdog() -> None:
    while True:
        left = BUDGET_S - _elapsed()
        if left <= 0:
            break
        time.sleep(min(left, 5.0))
    DETAIL["budget_expired_in"] = DETAIL.get("_section", "?")
    DETAIL.pop("_section", None)
    _emit()
    os._exit(0)


def _install_guards() -> None:
    threading.Thread(target=_watchdog, daemon=True).start()

    def on_term(signum, frame):
        DETAIL["killed_in"] = DETAIL.get("_section", "?")
        DETAIL.pop("_section", None)
        _emit()
        os._exit(0)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, on_term)
        except Exception:
            pass


def section(name: str, est_s: float, fn, ctx) -> None:
    """Run one optional section iff the budget still has ``est_s`` headroom;
    record elapsed/skip/error and checkpoint the partial JSON either way."""
    rem = _remaining()
    if rem < est_s:
        DETAIL["sections"][name] = {
            "skipped": f"budget: {rem:.0f}s left < {est_s:.0f}s estimate"}
        _save_partial()
        return
    DETAIL["_section"] = name
    t0 = time.perf_counter()
    try:
        fn(ctx)
        DETAIL["sections"][name] = {
            "elapsed_s": round(time.perf_counter() - t0, 1)}
    except Exception as e:
        DETAIL["sections"][name] = {
            "elapsed_s": round(time.perf_counter() - t0, 1),
            "error": repr(e)[:300]}
        print(f"# section {name} failed: {e!r}", flush=True)
    DETAIL.pop("_section", None)
    _save_partial()


def build_case(n_cell=64, n_levels=3, max_grid_size=32):
    from peleanalysis_tpu.amr.hierarchy import AmrMeta, AmrState
    from peleanalysis_tpu.testing import (default_fields, make_amr_hierarchy,
                                          make_level_data)

    geoms, bas, ratios = make_amr_hierarchy(
        n_cell=n_cell, n_levels=n_levels, max_grid_size=max_grid_size)
    names, data = make_level_data(geoms, bas, default_fields(3))
    meta = AmrMeta(geoms, bas, ratios)
    return AmrState.from_arrays(meta, names, data, dtype=np.float32), data


# --------------------------------------------------------------------------
# sections
# --------------------------------------------------------------------------

def sec_core(ctx) -> None:
    """The headline metric: grad + curvature + isosurface composite, traffic
    accounting, pinned-CPU vs_baseline."""
    import jax
    import jax.numpy as jnp

    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.geom.marching_cubes import extract_isosurface
    from peleanalysis_tpu.ops.dense_fill import fill_dense_multilevel
    from peleanalysis_tpu.ops.stencil import centered_gradient, magnitude

    state, raw = build_case()
    meta = state.meta
    n_lev = meta.n_levels
    ic = state.comp("temp")
    ip = state.comp("progress")
    dstate = DenseAmrState.from_batched(state)
    masks = [dstate.in_level_mask(l) for l in range(n_lev)]
    lmeta = dstate.lmeta
    ctx.update(state=state, raw=raw, meta=meta, n_lev=n_lev, ic=ic, ip=ip,
               dstate=dstate, masks=masks)

    def mlgrad_all(fields, mask_list):
        grown = fill_dense_multilevel(meta, lmeta, fields, mask_list, 1,
                                      None, "linear")
        return [centered_gradient(g, meta.geoms[lev].dx, 1)
                for lev, g in enumerate(grown)]

    def grad_chain(levels, mask_list):
        outs = []
        for lev, (gx, gy, gz) in enumerate(mlgrad_all(levels, mask_list)):
            outs.append(magnitude(gx, gy, gz))
        # K-chaining stabilizer: tanh is elementwise, so it FUSES into the
        # magnitude write (a max-normalize would add a reduction + rescale
        # pass per level that the real tool doesn't have)
        return [jnp.tanh(o) for o in outs]

    def curv_chain(levels, mask_list):
        # gradient -> normal -> div(normal) + grad-of-grad Hessian -> Kg
        # (per-component fills — measured faster than channel-batched, r3)
        g = mlgrad_all(levels, mask_list)
        G = [jnp.concatenate(gl, 0) for gl in g]
        normg = [-jnp.maximum(1e-14,
                              jnp.sqrt(jnp.sum(Gl**2, 0, keepdims=True)))
                 for Gl in G]
        N = [G[l] / normg[l] for l in range(n_lev)]
        gN = [mlgrad_all([N[l][d][None] for l in range(n_lev)], mask_list)
              for d in range(3)]
        gG = [mlgrad_all([G[l][i][None] for l in range(n_lev)], mask_list)
              for i in range(3)]
        outs = []
        for lev in range(n_lev):
            div = sum(gN[d][lev][d][0] for d in range(3))
            H = [[gG[i][lev][j][0] for j in range(3)] for i in range(3)]
            adj_num = 0.0
            for i in range(3):
                for j in range(3):
                    a = (H[(i + 1) % 3][(j + 1) % 3]
                         * H[(i + 2) % 3][(j + 2) % 3]
                         - H[(i + 1) % 3][(j + 2) % 3]
                         * H[(i + 2) % 3][(j + 1) % 3])
                    adj_num = adj_num + G[lev][i] * a * G[lev][j]
            # f32-safe: normg**4 underflows to 0 below |g|~1e-10, and the
            # resulting inf/nan (flat corners of the synthetic field) would
            # poison the chain's scalar reduction; the floor fuses for free
            Kg = adj_num / jnp.maximum(normg[lev][0] ** 4, 1e-30)
            Km = 0.5 * div
            outs.append(Km + 1e-6 * Kg)
        # tanh stabilizer fuses into the combine (see grad_chain note)
        return [jnp.tanh(o[None]) for o in outs]

    data_t = [d[ic: ic + 1] for d in dstate.data]
    data_p = [d[ip: ip + 1] for d in dstate.data]
    ctx.update(grad_chain=grad_chain, curv_chain=curv_chain,
               data_t=data_t, data_p=data_p)

    def timed_chain(fn, data, K):
        step = jax.jit(fn)
        jax.block_until_ready(step(data, masks))
        t0 = time.perf_counter()
        cur = data
        for _ in range(K):
            cur = step(cur, masks)
        jax.block_until_ready(cur)
        return (time.perf_counter() - t0) / K * 1e3

    grad_ms = timed_chain(grad_chain, data_t, 60)
    curv_ms = timed_chain(curv_chain, data_p, 20)

    # ---- traffic accounting (bytes the hand model moves per call; the
    # device peak to divide by is keyed by device_kind, not here) ----------
    cells = [int(np.prod(dstate.lmeta[l].bbox.shape)) for l in range(n_lev)]
    tot_cells = sum(cells)
    # traffic models (f32): grad chain touches ~9 arrays/cell (fill read,
    # 3 flux writes+reads, magnitude, normalize r/w); curvature ~45
    # (13-field pipeline: grad, N, 3x gN, 3x gG, Hessian/adjugate combines)
    grad_bytes = tot_cells * 4 * 9
    curv_bytes = tot_cells * 4 * 45
    roofline = {
        "grad": {"model_gb": round(grad_bytes / 1e9, 3),
                 "gb_s": round(grad_bytes / (grad_ms * 1e-3) / 1e9, 1)},
        "curvature": {"model_gb": round(curv_bytes / 1e9, 3),
                      "gb_s": round(curv_bytes / (curv_ms * 1e-3) / 1e9, 1)},
    }
    ctx["tot_cells"] = tot_cells

    # isosurface: end-to-end tool wall-clock (device enum engine + fetch)
    iso_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mef = extract_isosurface(dstate, "temp", 1000.0, classify="enum")
        iso_times.append(time.perf_counter() - t0)
    iso_ms = min(iso_times) * 1e3
    # device-vs-transfer split: re-run the cached enum fn with a scalar
    # reduction (device work only, no payload)
    try:
        from peleanalysis_tpu.geom import marching_cubes as _mc
        fn = dstate._mc_enum_fns[
            [k for k in dstate._mc_enum_fns if k[0] != "counts"][-1]]
        coord = _mc._coord_levels(dstate)
        dls = [jnp.concatenate([coord[l],
                                dstate.data[l][np.asarray([ic])]], axis=0)
               for l in range(n_lev)]
        okd = [_mc._ok_mask_dev(dstate, l)[0] for l in range(n_lev)]
        red = jax.jit(lambda *a: jnp.sum(fn(*a)[:8]))
        _ = float(red(dls, masks, dstate._mc_inlev_dev, okd, 1000.0))
        t0 = time.perf_counter()
        _ = float(red(dls, masks, dstate._mc_inlev_dev, okd, 1000.0))
        iso_dev_ms = (time.perf_counter() - t0) * 1e3
        roofline["isosurface"] = {
            "device_ms": round(iso_dev_ms, 1),
            "fetch_ms": round(iso_ms - iso_dev_ms, 1),
            "nodes": int(mef.n_nodes), "tris": int(mef.n_elts)}
    except Exception:
        pass
    gpu_ms = grad_ms + curv_ms + iso_ms

    # ---- CPU baseline: PINNED by default ----------------------------------
    # the live numpy numbers swing 2-3x with host load; BASELINE_CPU.json
    # pins the oracle timings of the identical numerics.
    # PELE_BENCH_LIVE_CPU=1 re-measures (sec_cpu_live).
    pinned = None
    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BASELINE_CPU.json")) as f:
            pinned = json.load(f)
    except Exception:
        pass
    ctx["pinned"] = pinned
    live_cpu = os.environ.get("PELE_BENCH_LIVE_CPU") == "1" or pinned is None
    ctx["live_cpu"] = live_cpu
    if pinned is not None:
        cpu_grad = pinned["cpu_grad_ms"] / 1e3
        cpu_curv = pinned["cpu_curvature_ms"] / 1e3
        cpu_iso = pinned["cpu_isosurface_ms"] / 1e3
        cpu_ms = (cpu_grad + cpu_curv + cpu_iso) * 1e3
        RESULT["vs_baseline"] = round(cpu_ms / gpu_ms, 2)
        DETAIL.update(cpu_grad_ms=round(cpu_grad * 1e3, 1),
                      cpu_curvature_ms=round(cpu_curv * 1e3, 1),
                      cpu_isosurface_ms=round(cpu_iso * 1e3, 1),
                      cpu_stream_ms=pinned.get("cpu_stream_ms"),
                      cpu_condmean_jpdf_ms=pinned.get(
                          "cpu_condmean_jpdf_ms"),
                      cpu_source="pinned")
    RESULT["value"] = round(gpu_ms, 3)
    DETAIL.update(grad_ms=round(grad_ms, 3),
                  curvature_ms=round(curv_ms, 3),
                  isosurface_ms=round(iso_ms, 3),
                  roofline=roofline)


def sec_cpu_live(ctx) -> None:
    """PELE_BENCH_LIVE_CPU=1: re-measure the CPU oracle numerics live
    (otherwise the pinned BASELINE_CPU.json numbers stand)."""
    from peleanalysis_tpu.geom.marching_cubes import extract_isosurface
    from peleanalysis_tpu.ops.fill import get_fill_plan
    from peleanalysis_tpu.reference_impl import (numpy_binned_stats,
                                                 numpy_curvature,
                                                 numpy_grad_level,
                                                 numpy_joint_pdf, numpy_trace)

    meta, raw, n_lev = ctx["meta"], ctx["raw"], ctx["n_lev"]
    ic, ip, dstate = ctx["ic"], ctx["ip"], ctx["dstate"]
    plans = []
    for lev in range(n_lev):
        ba_c = meta.bas[lev - 1] if lev > 0 else None
        ps_c = meta.pad_shape(lev - 1) if lev > 0 else None
        ratio = meta.ref_ratio[lev - 1] if lev > 0 else 2
        plans.append(get_fill_plan(meta.bas[lev], meta.geoms[lev], 1,
                                   meta.pad_shape(lev), ba_c, ps_c, ratio,
                                   None, "linear"))
    np_t, np_p = [], []
    for lev in range(n_lev):
        for arrs, comp in ((np_t, ic), (np_p, ip)):
            a = np.zeros((len(meta.bas[lev]), 1) + meta.pad_shape(lev))
            for i, f in enumerate(raw[lev]):
                sl = (i, 0) + tuple(slice(0, s) for s in f.shape[1:])
                a[sl] = f[comp]
            arrs.append(a)
    dxs = [meta.geoms[lev].dx for lev in range(n_lev)]

    t0 = time.perf_counter()
    for lev in range(n_lev):
        numpy_grad_level(plans[lev], np_t[lev],
                         np_t[lev - 1] if lev > 0 else None, dxs[lev])
    cpu_grad = time.perf_counter() - t0
    t0 = time.perf_counter()
    numpy_curvature(plans, np_p, dxs)
    cpu_curv = time.perf_counter() - t0
    # warm once so the device->host transfer of the filled arrays (cached
    # on the state) doesn't count against the CPU engine's compute time
    extract_isosurface(dstate, "temp", 1000.0, classify="numpy")
    t0 = time.perf_counter()
    extract_isosurface(dstate, "temp", 1000.0, classify="numpy")
    cpu_iso = time.perf_counter() - t0
    cpu_ms = (cpu_grad + cpu_curv + cpu_iso) * 1e3
    DETAIL.update(cpu_grad_ms=round(cpu_grad * 1e3, 1),
                  cpu_curvature_ms=round(cpu_curv * 1e3, 1),
                  cpu_isosurface_ms=round(cpu_iso * 1e3, 1),
                  cpu_source="live")
    if RESULT["value"]:
        RESULT["vs_baseline"] = round(cpu_ms / RESULT["value"], 2)

    # stream CPU oracle (config 4)
    state, dstate, meta = ctx["state"], ctx["dstate"], ctx["meta"]
    fin = ctx["n_lev"] - 1
    geom_f = meta.geoms[fin]
    vel = np.asarray(dstate.data[fin][
        np.asarray([state.comp(n) for n in
                    ("x_velocity", "y_velocity", "z_velocity")])],
        dtype=np.float64)
    bboxf = dstate.lmeta[fin].bbox
    plo_f = (np.array(geom_f.prob_lo)
             + (np.array(bboxf.lo) - np.array(geom_f.domain.lo))
             * np.array(geom_f.dx))
    seeds = ctx.get("seeds")
    if seeds is None:
        rng = np.random.default_rng(0)
        seeds = 0.5 + 0.12 * (rng.random((4096, 3)) - 0.5)
    t0 = time.perf_counter()
    numpy_trace(vel, plo_f, np.array(geom_f.dx), seeds, 25,
                0.5 * geom_f.dx[0])
    DETAIL["cpu_stream_ms"] = round((time.perf_counter() - t0) * 1e3, 1)

    # stats CPU oracle (config 5)
    t0 = time.perf_counter()
    w = [64, 8, 1]
    for lev in range(ctx["n_lev"]):
        p = np.asarray(dstate.data[lev][state.comp("temp")])
        d = np.asarray(dstate.data[lev][state.comp("density")])
        q = np.asarray(dstate.data[lev][state.comp("progress")])
        m = np.asarray(dstate.valid_mask(lev))
        numpy_binned_stats(p, d[None], w[lev], m, 300.0, 1801.0, 64)
        numpy_joint_pdf(p, q, 1.0, m, 300.0, 1801.0, -0.1, 1.1, 64)
    DETAIL["cpu_condmean_jpdf_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 1)


def sec_stream(ctx) -> None:
    """BASELINE config 4: RK4 streamlines; plus the march-precision artifact
    (f32 is the march default, bf16 the opt-in)."""
    import jax
    import jax.numpy as jnp

    from peleanalysis_tpu.stream.trace import trace_streamlines

    dstate, meta, state, n_lev = (ctx["dstate"], ctx["meta"], ctx["state"],
                                  ctx["n_lev"])
    rng = np.random.default_rng(0)
    seeds = 0.5 + 0.12 * (rng.random((4096, 3)) - 0.5)
    ctx["seeds"] = seeds
    trace_streamlines(dstate, seeds, 51, 0.5, trace_field=None)  # warm
    t0 = time.perf_counter()
    lines = trace_streamlines(dstate, seeds, 51, 0.5, trace_field=None)
    stream_ms = (time.perf_counter() - t0) * 1e3
    DETAIL["stream_4096lines_ms"] = round(stream_ms, 1)

    # march precision artifact: default (f32) vs bf16 opt-in — wall-clock
    # and max path deviation in finest cells, so the lossy option's cost/
    # benefit is measured, not asserted
    try:
        lb = trace_streamlines(dstate, seeds, 51, 0.5, trace_field=None,
                               march_dtype="bfloat16")         # warm
        t0 = time.perf_counter()
        lb = trace_streamlines(dstate, seeds, 51, 0.5, trace_field=None,
                               march_dtype="bfloat16")
        bf16_ms = (time.perf_counter() - t0) * 1e3
        dxf = float(min(meta.geoms[n_lev - 1].dx))
        dev = float(np.max(np.abs(
            np.asarray(lb[:, :, :3], np.float64)
            - np.asarray(lines[:, :, :3], np.float64)))) / dxf
        DETAIL["march_precision"] = {
            "f32_ms": round(stream_ms, 1), "bf16_ms": round(bf16_ms, 1),
            "max_dev_finest_cells": round(dev, 4),
            "note": "f32 default (reference is double everywhere, "
                    "stream_nd.f90); bf16 opt-in via march_dtype"}
    except Exception as e:
        print(f"# march precision probe skipped: {e!r}")


def sec_stats(ctx) -> None:
    """BASELINE config 5: conditionalMean + jpdf as ONE fused dispatch +
    ONE fetch; then the device time of K back-to-back fused dispatches."""
    import jax
    import jax.numpy as jnp

    from peleanalysis_tpu.tools.conditional_mean import (
        _accumulate_all, accumulate_stats_fused, refinement_weights)
    from peleanalysis_tpu.tools.jpdf import _jpdf_all

    dstate, state, meta, n_lev = (ctx["dstate"], ctx["state"], ctx["meta"],
                                  ctx["n_lev"])
    tot_cells = ctx["tot_cells"]
    pair_b = (300.0, 1801.0, -0.1, 1.1)
    accumulate_stats_fused(dstate, "temp", ["density"], 64, 300.0, 1801.0,
                           ("temp", "progress"), pair_b, 64)   # warm
    t0 = time.perf_counter()
    accumulate_stats_fused(dstate, "temp", ["density"], 64, 300.0, 1801.0,
                           ("temp", "progress"), pair_b, 64)
    stats_ms = (time.perf_counter() - t0) * 1e3
    DETAIL["condmean_jpdf_ms"] = round(stats_ms, 1)
    svols = tuple(float(np.prod(meta.geoms[lev].dx))
                  for lev in range(n_lev))
    sweights = tuple(refinement_weights(meta.ref_ratio, n_lev, 3))
    smasks = [dstate.valid_mask(lev) for lev in range(n_lev)]
    ibs, ias = state.comp("temp"), (state.comp("density"),)
    f1 = [dstate.data[l][state.comp("temp")] for l in range(n_lev)]
    f2 = [dstate.data[l][state.comp("progress")] for l in range(n_lev)]

    def _fused_dev(dl, ml, g1, g2, tok):
        cm = _accumulate_all(dl, ml, ibs, ias, sweights, 300.0, 1801.0, 64,
                             False)
        jp = _jpdf_all(g1, g2, ml, svols, pair_b, 64)
        # tok threads a data dependency so K calls form one executed chain
        return tok + sum(jnp.sum(x) for x in cm) \
            + sum(jnp.sum(x) for x in jp)

    def chain_ms(fn, args, K=16):
        jax.block_until_ready(fn(*args, jnp.zeros(())))
        t0 = time.perf_counter()
        acc = jnp.zeros(())
        for _ in range(K):
            acc = fn(*args, acc)
        jax.block_until_ready(acc)
        return (time.perf_counter() - t0) / K * 1e3

    dev_ms = chain_ms(jax.jit(_fused_dev), (list(dstate.data), smasks,
                                            f1, f2))
    # FLOPs of the one-hot contractions: condMean = one [64,C]@[C,3]
    # matmul; jpdf = one batched 3x [64,C]@[C,64].  Onehot build not
    # counted.
    stats_gflop = (2 * tot_cells * 64 * 3
                   + 2 * tot_cells * 64 * 64 * 3) / 1e9
    DETAIL["roofline"]["stats_matmul"] = {
        "gflop": round(stats_gflop, 1), "device_ms": round(dev_ms, 3),
        "gflop_s": round(stats_gflop / (dev_ms * 1e-3), 1)}

    # all-pairs jpdf: 3 vars -> 3 pairs sharing per-variable one-hots in
    # one dispatch (tools/jpdf.compute_jpdf_pairs)
    if _remaining() > 30:
        from peleanalysis_tpu.tools.jpdf import _jpdf_multi_all
        f3 = [dstate.data[l][state.comp("density")] for l in range(n_lev)]
        vals_list = [jnp.stack([f1[l], f2[l], f3[l]]) for l in range(n_lev)]
        mlo = np.asarray([300.0, -0.1, 0.05], np.float32)
        mhi = np.asarray([1801.0, 1.1, 1.3], np.float32)
        mpairs = ((0, 1), (0, 2), (1, 2))

        def _multi_dev(vl, ml, tok):
            b, bx1, bx2, _sh = _jpdf_multi_all(vl, ml, svols, mlo, mhi,
                                               64, mpairs)
            return tok + jnp.sum(b) + jnp.sum(bx1) + jnp.sum(bx2)

        dev2_ms = chain_ms(jax.jit(_multi_dev), (vals_list, smasks))
        gf_multi = 3 * 2 * tot_cells * 64 * 64 * 3 / 1e9
        DETAIL["roofline"]["stats_jpdf_multi"] = {
            "gflop": round(gf_multi, 1), "device_ms": round(dev2_ms, 3),
            "device_ms_per_pair": round(dev2_ms / 3, 3),
            "gflop_s": round(gf_multi / (dev2_ms * 1e-3), 1),
            "case": "3 vars -> 3 pairs, shared one-hots, one dispatch"}


def sec_chain(ctx) -> None:
    """Device-resident chained composite (pipeline mode): grad -> curvature
    -> isosurface(defer: counts-only fetch) -> stream seeded from the
    surface's xyz columns; only final artifacts fetched (seed xyz +
    compressed lines).  This is what `pipeline ... write=0` buys."""
    import jax
    import jax.numpy as jnp

    from peleanalysis_tpu.geom.marching_cubes import extract_isosurface
    from peleanalysis_tpu.stream.trace import trace_streamlines

    dstate = ctx["dstate"]
    masks, data_t, data_p = ctx["masks"], ctx["data_t"], ctx["data_p"]
    seeds = ctx["seeds"]
    gfn = jax.jit(ctx["grad_chain"])
    cfn = jax.jit(ctx["curv_chain"])
    # grad+curv reduce to TWO scalars shipped inside the stream fetch —
    # the chain makes exactly 2 device-to-host copies: the deferred
    # surface's head+xyz (overlapping the queued grad/curv/enum device
    # work) and DeferredLines.finish's single packed lines+scalars vector
    scal = jax.jit(lambda a, b: jnp.stack(
        [sum(jnp.sum(x) for x in a),
         sum(jnp.sum(x) for x in b)]).astype(jnp.float32))
    dsurf = extract_isosurface(dstate, "temp", 1000.0, classify="enum",
                               defer=True)
    seeds_c = np.ascontiguousarray(dsurf.positions()[:4096])
    if len(seeds_c) < 4096:
        seeds_c = np.concatenate(
            [seeds_c, seeds[: 4096 - len(seeds_c)]])
    dl = trace_streamlines(dstate, seeds_c, 51, 0.5, trace_field=None,
                           defer=True)                             # warm
    dl.finish(extra=[scal(gfn(data_t, masks), cfn(data_p, masks))])
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        g1 = gfn(data_t, masks)          # queued on device
        c1 = cfn(data_p, masks)          # queued on device
        dsurf = extract_isosurface(dstate, "temp", 1000.0,
                                   classify="enum", defer=True)
        sc = np.ascontiguousarray(dsurf.positions()[:4096])
        if len(sc) < 4096:
            sc = np.concatenate([sc, seeds[: 4096 - len(sc)]])
        dl = trace_streamlines(dstate, sc, 51, 0.5, trace_field=None,
                               defer=True)
        lines_c, ex = dl.finish(extra=[scal(g1, c1)])
        assert np.isfinite(ex[0]).all()
        times.append(time.perf_counter() - t0)
    DETAIL["pipeline_chain_ms"] = round(min(times) * 1e3, 1)


def sec_sparse512(ctx) -> None:
    """Sparse-refinement scale story: scattered 512^3 finest level, <1%
    coverage, 16 clusters.  Canonical frames let equal-bucket clusters
    share ONE compiled engine (amr/canonical.py), so this is where the
    clustered design wins — cold AND warm numbers, plus the cluster/frame
    build split."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates
    from peleanalysis_tpu.geom.marching_cubes import (
        extract_isosurface_sparse)
    from peleanalysis_tpu.testing import default_fields, make_scattered_state

    blk: dict = {"case": "128^3 coarse + 16 scattered 32^3 clusters on a "
                         "512^3 finest index space (ratio 4, <1% coverage)"}
    DETAIL["sparse_512"] = blk
    t0 = time.perf_counter()
    st, ba1 = make_scattered_state(fields=default_fields(3))
    blk["build_host_s"] = round(time.perf_counter() - t0, 1)
    blk["coverage_pct"] = round(100 * ba1.total_cells() / 512**3, 3)

    # clustering + canonical frame construction (same args the sparse iso
    # uses, so the iso timings below exclude this host phase)
    t0 = time.perf_counter()
    groups, subs, base, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=0, waste_factor=4.0)
    blk["cluster_frames_s"] = round(time.perf_counter() - t0, 1)
    blk["n_clusters"] = len(groups)
    blk["n_canonical"] = sum(1 for i in infos if i.canonical)

    t0 = time.perf_counter()
    mef = extract_isosurface_sparse(st, "temp", 800.0, [])
    blk["iso_cold_s"] = round(time.perf_counter() - t0, 1)
    blk["iso_nodes"] = int(mef.n_nodes)
    blk["iso_tris"] = int(mef.n_elts)
    if _remaining() > 30:
        t0 = time.perf_counter()
        mef2 = extract_isosurface_sparse(st, "temp", 900.0, [])
        blk["iso_warm_new_value_s"] = round(time.perf_counter() - t0, 2)
        blk["iso_warm_tris"] = int(mef2.n_elts)
    if _remaining() > 120:
        from peleanalysis_tpu.stream.trace import trace_streamlines_sparse
        seeds = mef.positions()[
            np.random.default_rng(1).choice(mef.n_nodes,
                                            min(2048, mef.n_nodes),
                                            replace=False)]
        t0 = time.perf_counter()
        lines = trace_streamlines_sparse(st, seeds, 31, 0.5,
                                         trace_field=None)
        blk["stream_cold_s"] = round(time.perf_counter() - t0, 1)
        blk["stream_lines"] = int(lines.shape[0])
        t0 = time.perf_counter()
        trace_streamlines_sparse(st, seeds, 31, 0.5, trace_field=None)
        blk["stream_warm_s"] = round(time.perf_counter() - t0, 2)


def sec_cli32(ctx) -> None:
    """CLI-level: file-chained tools vs pipeline mode — the user-facing win
    of `pipeline ... -- ...`: shared plotfile loads, dense conversions and
    engine builds, in-session intermediate artifacts.  Real on-disk
    plotfile (32^3 x 3 levels, ~2.4M cells)."""
    import shutil
    import tempfile

    from peleanalysis_tpu.cli import main as cli_main
    from peleanalysis_tpu.testing import write_synthetic_plotfile
    td = tempfile.mkdtemp()
    pltf = os.path.join(td, "plt")
    write_synthetic_plotfile(pltf, n_cell=32, n_levels=3)

    def run_seq(tag):
        b = os.path.join(td, tag)
        cli_main(["grad", f"infile={pltf}", "gradVar=temp",
                  f"outfile={b}_g"])
        cli_main(["curvature", f"infile={pltf}", "progressName=temp",
                  f"outfile={b}_K"])
        cli_main(["isosurface", f"infile={pltf}", "isoCompName=temp",
                  "isoVal=800", f"outfile_base={b}_iso"])
        cli_main(["stream", f"plotfile={pltf}", "traceAlongV=1",
                  f"isoFile={b}_iso.mef", "nRKsteps=21",
                  f"outFile={b}_lines.dat"])

    def run_pipe(tag):
        b = os.path.join(td, tag)
        cli_main(["pipeline",
                  "grad", f"infile={pltf}", "gradVar=temp",
                  f"outfile={b}_g", "--",
                  "curvature", f"infile={pltf}", "progressName=temp",
                  f"outfile={b}_K", "--",
                  "isosurface", f"infile={pltf}", "isoCompName=temp",
                  "isoVal=800", f"outfile_base={b}_iso", "write=0",
                  "--",
                  "stream", f"plotfile={pltf}", "traceAlongV=1",
                  f"isoFile={b}_iso.mef", "nRKsteps=21",
                  f"outFile={b}_lines.dat"])

    try:
        run_seq("w1")        # warm compiles/caches for both paths
        run_pipe("w2")
        seqs, pipes = [], []
        for i in range(2):   # interleaved min-of-2
            t0 = time.perf_counter()
            run_seq(f"s{i}")
            seqs.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            run_pipe(f"p{i}")
            pipes.append(time.perf_counter() - t0)
        DETAIL["cli_sequential_ms"] = round(min(seqs) * 1e3, 1)
        DETAIL["cli_pipeline_ms"] = round(min(pipes) * 1e3, 1)
    finally:
        shutil.rmtree(td, ignore_errors=True)


def sec_server(ctx) -> None:
    """Server mode: same 4-tool chain through the persistent server
    (peleanalysis_tpu serve) — one resident Session, warm engines across
    commands; the AOT-binary startup-cost analog.  Short per-command socket
    timeouts, so a wedged command cannot eat the bench's budget."""
    import shutil
    import tempfile
    import threading as _th

    from peleanalysis_tpu.server import send_command, serve
    from peleanalysis_tpu.testing import write_synthetic_plotfile
    td = tempfile.mkdtemp()
    pltf = os.path.join(td, "plt")
    write_synthetic_plotfile(pltf, n_cell=32, n_levels=3)
    sock = os.path.join(td, "s.sock")
    th = _th.Thread(target=serve, args=({"socket": [sock]},), daemon=True)
    th.start()
    for _ in range(100):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    # per-command timeout: generous for a warm 32^3 command, but bounded by
    # the section's remaining budget so a wedged compile can't eat the run
    cmd_to = max(10.0, min(60.0, _remaining() / 4))

    def run_srv(tag):
        b = os.path.join(td, tag)
        for argv in (
            ["grad", f"infile={pltf}", "gradVar=temp",
             f"outfile={b}_g"],
            ["curvature", f"infile={pltf}", "progressName=temp",
             f"outfile={b}_K"],
            ["isosurface", f"infile={pltf}", "isoCompName=temp",
             "isoVal=800", f"outfile_base={b}_iso"],
            ["stream", f"plotfile={pltf}", "traceAlongV=1",
             f"isoFile={b}_iso.mef", "nRKsteps=21",
             f"outFile={b}_lines.dat"]):
            rep = send_command(sock, argv=argv, timeout=cmd_to)
            assert rep["rc"] == 0, rep["err"]

    try:
        run_srv("sw")                       # warm
        ts = []
        for i in range(2):
            t0 = time.perf_counter()
            run_srv(f"sv{i}")
            ts.append(time.perf_counter() - t0)
        DETAIL["cli_server_ms"] = round(min(ts) * 1e3, 1)
    finally:
        try:
            send_command(sock, cmd="shutdown", timeout=10.0)
            th.join(timeout=10)
        except Exception:
            pass
        shutil.rmtree(td, ignore_errors=True)


def sec_e2e_512(ctx) -> None:
    """Dense scale pair: 128^3 x 3 levels (finest 512^3 index space, ~21M
    padded cells) — isosurface and stream end-to-end at deployment
    scale."""
    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.geom.marching_cubes import extract_isosurface
    from peleanalysis_tpu.stream.trace import trace_streamlines

    blk: dict = {"case": "128^3 x 3 levels dense (finest 512^3 index "
                         "space), iso + 4096-line stream e2e"}
    DETAIL["e2e_512"] = blk
    t0 = time.perf_counter()
    state, _ = build_case(n_cell=128, n_levels=3, max_grid_size=64)
    dstate = DenseAmrState.from_batched(state)
    blk["build_upload_s"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    mef = extract_isosurface(dstate, "temp", 1000.0, classify="enum")
    blk["iso_cold_s"] = round(time.perf_counter() - t0, 1)
    blk["iso_nodes"], blk["iso_tris"] = int(mef.n_nodes), int(mef.n_elts)
    if _remaining() > 30:
        t0 = time.perf_counter()
        extract_isosurface(dstate, "temp", 1000.0, classify="enum")
        blk["iso_warm_ms"] = round((time.perf_counter() - t0) * 1e3, 0)
    if _remaining() > 60:
        seeds = np.ascontiguousarray(mef.positions()[:4096])
        t0 = time.perf_counter()
        trace_streamlines(dstate, seeds, 51, 0.5, trace_field=None)
        blk["stream_cold_s"] = round(time.perf_counter() - t0, 1)
        if _remaining() > 30:
            t0 = time.perf_counter()
            trace_streamlines(dstate, seeds, 51, 0.5, trace_field=None)
            blk["stream_warm_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 0)


def sec_large(ctx) -> None:
    """LARGE-scale pipeline vs sequential (96^3 x 3, ~8M cells): the scale
    where shared loads/uploads/fills dominate per-invocation Python.  One
    timed pass each."""
    import shutil
    import tempfile

    from peleanalysis_tpu.cli import main as cli_main
    from peleanalysis_tpu.testing import write_synthetic_plotfile
    td = tempfile.mkdtemp()
    pltf = os.path.join(td, "plt")
    write_synthetic_plotfile(pltf, n_cell=96, n_levels=3)

    def seq_l(tag):
        b = os.path.join(td, tag)
        cli_main(["grad", f"infile={pltf}", "gradVar=temp",
                  f"outfile={b}_g"])
        cli_main(["curvature", f"infile={pltf}",
                  "progressName=temp", f"outfile={b}_K"])
        cli_main(["isosurface", f"infile={pltf}",
                  "isoCompName=temp", "isoVal=800",
                  f"outfile_base={b}_iso"])
        cli_main(["stream", f"plotfile={pltf}", "traceAlongV=1",
                  f"isoFile={b}_iso.mef", "nRKsteps=21",
                  f"outFile={b}_lines.dat"])

    def pipe_l(tag):
        b = os.path.join(td, tag)
        cli_main(["pipeline",
                  "grad", f"infile={pltf}", "gradVar=temp",
                  f"outfile={b}_g", "write=0", "--",
                  "curvature", f"infile={pltf}",
                  "progressName=temp", f"outfile={b}_K",
                  "write=0", "--",
                  "isosurface", f"infile={pltf}",
                  "isoCompName=temp", "isoVal=800",
                  f"outfile_base={b}_iso", "write=0", "--",
                  "stream", f"plotfile={pltf}", "traceAlongV=1",
                  f"isoFile={b}_iso.mef", "nRKsteps=21",
                  f"outFile={b}_lines.dat"])

    try:
        pipe_l("lw")                    # warm compiles for this shape
        t0 = time.perf_counter()
        seq_l("ls")
        seq_large = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipe_l("lp")
        pipe_large = time.perf_counter() - t0
        DETAIL["cli_pipeline_large"] = {
            "cli_sequential_ms": round(seq_large * 1e3, 0),
            "cli_pipeline_ms": round(pipe_large * 1e3, 0),
            "speedup": round(seq_large / pipe_large, 2),
            "case": "96^3 x 3 levels, 4-tool chain"}
    finally:
        shutil.rmtree(td, ignore_errors=True)


def main():
    from peleanalysis_tpu.utils import gpu_cards
    print(gpu_cards(), flush=True)     # card name, power limit
    import jax

    from peleanalysis_tpu.config import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()
    if dev[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev}")
    DETAIL["device"] = {"platform": dev[0].platform,
                        "kind": dev[0].device_kind, "count": len(dev)}
    _install_guards()
    _save_partial()
    ctx: dict = {}
    # the core composite is the headline metric: always attempted
    section("core", 0, sec_core, ctx)
    if RESULT["value"] is None:
        _emit()          # core failed outright: report what we know
        return
    if ctx.get("live_cpu"):
        section("cpu_live", 60, sec_cpu_live, ctx)
    section("stream", 45, sec_stream, ctx)
    section("stats", 45, sec_stats, ctx)
    section("chain", 45, sec_chain, ctx)
    # e2e_512 before the CLI chains: the scale story is worth more than
    # warm-chain timings when the budget is tight
    section("sparse_512", 240, sec_sparse512, ctx)
    section("e2e_512", 200, sec_e2e_512, ctx)
    section("cli32", 150, sec_cli32, ctx)
    section("server", 120, sec_server, ctx)
    if os.environ.get("PELE_BENCH_LARGE", "1") != "0":
        section("large", 240, sec_large, ctx)
    _emit()


if __name__ == "__main__":
    main()
