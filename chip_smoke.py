#!/usr/bin/env python3
"""Smoke run of the main path on one GPU: plotfile -> derived fields ->
isosurface -> streamlines -> statistics, through the CLI entry points.

    python3 chip_smoke.py              # one GPU
    python3 chip_smoke.py --four-gpus  # the sharded paths on four GPUs only

One JAX process holds the card.  Its only children are ``nvidia-smi`` and
the pytest run of the GPU-marked tests, which ends before this process
first touches the card.  Phases, in order:

1. the card's name and power limit from ``nvidia-smi`` (no card: fail);
2. ``pytest -m gpu tests/`` with ``JAX_PLATFORMS=cuda``: every GPU parity
   test against the float64 references, none skipped;
3. at deployment size (a 3-level 128^3 synthetic plotfile, about 19.4 M
   cells, 6 components): the grad -> curvature -> isosurface -> stream
   pipeline, conditionalMean, jpdf and three requests to a ``serve``
   thread, cold then warm, each artifact checked for shape and
   finiteness; the XLA streamline march timed warm at 4096 seeds x 51
   stations.

With ``--four-gpus`` only the four-card paths run:
``__graft_entry__.dryrun_multichip(4)``, then grad, curvature and
isosurface with ``ndevices=4`` (X slabs and a 2x2 mesh) against the same
tools on one card.

Any failure raises and exits non-zero.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_CELL = 128          # level-0 cells per side; levels 1-2 refine by 2
MAX_GRID = 64
ISO_VAL = 1000.0


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 -----------------------------------------------------------------

def card_check(n_cards: int) -> None:
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and not ({"cuda", "gpu"} & set(plat.split(","))):
        raise SystemExit(f"JAX_PLATFORMS={plat} excludes the GPU")
    sys.path.insert(0, HERE)
    from peleanalysis_tpu.utils import gpu_cards
    cards = gpu_cards()
    log(cards)
    if len(cards.splitlines()) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, nvidia-smi lists "
                         f"{len(cards.splitlines())}")


# -- phase 2 -----------------------------------------------------------------

def gpu_tests() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cuda",
               PYTHONPATH=os.pathsep.join(
                   [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q", "-s",
         "-rs", "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    for line in r.stdout.splitlines():
        if line.startswith("parity ") or "Error" in line:
            log(line)
    summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if r.returncode != 0 or "skipped" in summary or "passed" not in summary:
        log("\n".join(r.stdout.strip().splitlines()[-40:]))
        log(r.stderr[-4000:])
        raise SystemExit(f"GPU tests failed (rc={r.returncode}): {summary}")
    log(f"phase 2: GPU tests {summary.strip('= ')} "
        f"({time.perf_counter() - t0:.1f} s)")


def open_device(count: int):
    import jax

    from peleanalysis_tpu.config import enable_compile_cache
    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(f"JAX found {devs}, need {count} GPU(s)")
    log(f"device: {devs[0].device_kind} x{len(devs)} "
        f"(platform {devs[0].platform}, jax {jax.__version__})")
    return devs


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


# -- artifact checks ---------------------------------------------------------

def check_plotfile(path: str, comps) -> None:
    """Every named comp is finite on the valid cells of every level."""
    import numpy as np

    from peleanalysis_tpu.io.plotfile import PlotfileReader
    from peleanalysis_tpu.tools.compare_plts import _per_box_valid
    r = PlotfileReader(path)
    idx = [r.var_index(c) for c in comps]
    for lev, ib, valid in _per_box_valid(r):
        f = r.read_box(lev, ib, idx)
        for k, c in enumerate(comps):
            bad = int((~np.isfinite(f[k][valid])).sum())
            if bad:
                raise AssertionError(f"{path}:{c}: {bad} cells not finite "
                                     f"(level {lev}, box {ib})")


def check_lines(path: str) -> int:
    import numpy as np

    from peleanalysis_tpu.io.stream_data import read_stream_data
    sd = read_stream_data(path)
    lines = np.asarray(sd.lines)
    if lines.ndim != 3 or lines.shape[1] != 51 or lines.shape[0] == 0:
        raise AssertionError(f"{path}: lines of shape {lines.shape}")
    if not np.isfinite(lines).all():
        raise AssertionError(f"{path}: non-finite line stations")
    return int(lines.shape[0])


def check_cm_table(path: str, nbins: int = 64) -> None:
    """A conditionalMean Tecplot table: VARIABLES and ZONE lines, then one
    finite row per bin."""
    import numpy as np
    vals = np.loadtxt(path, skiprows=2, ndmin=2)
    if vals.shape[0] != nbins or not np.isfinite(vals).all():
        raise AssertionError(f"{path}: {vals.shape} table, or non-finite")


# -- phase 3 -----------------------------------------------------------------

def pipeline_stages(plt: str, tag: str):
    return [
        ["grad", f"infile={plt}", "gradVar=temp", f"outfile={tag}_grad"],
        ["curvature", f"infile={plt}", "progressName=temp",
         "do_gaussCurv=1", "do_strain=1", f"outfile={tag}_curv"],
        ["isosurface", f"infile={plt}", "isoCompName=temp",
         f"isoVal={ISO_VAL}", f"outfile_base={tag}_iso", "write=0"],
        ["stream", f"plotfile={plt}", "traceAlongV=1",
         f"isoFile={tag}_iso.mef", "nRKsteps=51", "hRK=0.5",
         f"streamFile={tag}_lines"],
    ]


def run_stages(stages):
    """The ``pipeline`` tool's own loop (cli.main), timed per stage."""
    from peleanalysis_tpu.cli import main as cli_main
    from peleanalysis_tpu.session import Session
    sess = Session(async_writes=True)
    times = {}
    for st in stages:
        t0 = time.perf_counter()
        sess.flush_writes(match=st)
        rc = cli_main(st, session=sess)
        if rc != 0:
            raise AssertionError(f"stage {st[0]} rc={rc}")
        times[st[0]] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.flush_writes()
    times["write-back"] = time.perf_counter() - t0
    return times


def cli(argv) -> float:
    from peleanalysis_tpu.cli import main as cli_main
    t0 = time.perf_counter()
    rc = cli_main(argv)
    if rc != 0:
        raise AssertionError(f"{argv[0]} rc={rc}")
    return time.perf_counter() - t0


def write_plotfile(plt: str, n_cell: int, max_grid: int) -> None:
    from peleanalysis_tpu.testing import write_synthetic_plotfile
    t0 = time.perf_counter()
    geoms, bas, _, names, _ = write_synthetic_plotfile(
        plt, n_cell=n_cell, n_levels=3, max_grid_size=max_grid)
    cells = [b.total_cells() for b in bas]
    log(f"plotfile: {len(names)} comps, cells per level {cells} "
        f"(total {sum(cells)}), written in "
        f"{time.perf_counter() - t0:.1f} s")


def main_path(dev, n_cell: int, max_grid: int) -> None:
    import numpy as np

    plt = os.path.abspath("plt")
    write_plotfile(plt, n_cell, max_grid)
    cold = run_stages(pipeline_stages(plt, "c"))
    log("pipeline cold (s): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in cold.items()))
    warm = run_stages(pipeline_stages(plt, "w"))
    log("pipeline warm (s): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in warm.items()))
    setup = sum(cold.values()) - sum(warm.values())
    log(f"pipeline set-up (cold - warm, mostly compilation): {setup:.3f} s")
    argv = ["pipeline"]
    for st in pipeline_stages(plt, "p"):
        argv += st + ["--"]
    log(f"pipeline (one CLI call, warm): {cli(argv[:-1]):.3f} s")
    for tag in ("c", "w", "p"):
        check_plotfile(f"{tag}_grad", ["||gradtemp||", "temp_gx"])
        check_plotfile(f"{tag}_curv", ["MeanCurvature_temp",
                                       "GaussianCurvature_temp",
                                       "StrainRate_temp"])
        if os.path.exists(f"{tag}_iso.mef"):
            raise AssertionError("write=0 isosurface reached the disk")
    n_lines = check_lines("w_lines")
    log(f"stream: {n_lines} lines x 51 stations, finite")

    cm = ["conditionalMean", f"infile={plt}", "binComp=temp",
          "avgComps=density progress", "nBins=64", "binMin=300",
          "binMax=1801", "outfile=CM_temp.dat"]
    jp = ["jpdf", f"infile={plt}", "vars=temp progress density",
          "nBins=64", "output_gnuplot=1"]
    for name, argv in (("conditionalMean", cm), ("jpdf", jp)):
        c, w = cli(argv), cli(argv)
        log(f"{name}: cold {c:.3f} s, warm {w:.3f} s")
    check_cm_table("CM_temp.dat")
    pdfs = [f for f in os.listdir(plt) if f.startswith("Pdf_")]
    if not pdfs:
        raise AssertionError("jpdf wrote no Pdf_* files")

    serve_requests(plt)
    march_time(plt)
    log(f"peak device memory: {peak_bytes(dev)} bytes")


def serve_requests(plt: str) -> None:
    from peleanalysis_tpu.server import send_command, serve
    sock = os.path.abspath("serve.sock")
    th = threading.Thread(target=serve, args=({"socket": [sock]},),
                          daemon=True)
    th.start()
    for _ in range(200):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    reqs = [
        ["isosurface", f"infile={plt}", "isoCompName=temp", "isoVal=1200",
         "outfile_base=srv_iso"],
        ["grad", f"infile={plt}", "gradVar=temp", "outfile=srv_grad"],
        ["conditionalMean", f"infile={plt}", "binComp=temp",
         "avgComps=density", "nBins=64", "binMin=300", "binMax=1801",
         "outfile=srv_CM.dat"],
    ]
    try:
        for argv in reqs:
            t0 = time.perf_counter()
            rep = send_command(sock, argv=argv, timeout=600.0, sync=True)
            if rep["rc"] != 0:
                raise AssertionError(f"serve {argv[0]}: {rep['err']}")
            log(f"serve {argv[0]}: {time.perf_counter() - t0:.3f} s")
    finally:
        send_command(sock, cmd="shutdown", timeout=60.0)
        th.join(timeout=60)
    from peleanalysis_tpu.io.mef import read_mef
    import numpy as np
    mef = read_mef("srv_iso.mef")
    if mef.n_elts == 0 or not np.isfinite(mef.nodes).all():
        raise AssertionError("serve isosurface: empty or non-finite")
    check_plotfile("srv_grad", ["||gradtemp||"])
    check_cm_table("srv_CM.dat")


def march_time(plt: str) -> None:
    """Warm time of the XLA RK4 march (stream/trace.py _trace_level) on
    the finest level: 4096 seeds x 51 stations (both directions)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.amr.hierarchy import AmrState
    from peleanalysis_tpu.stream.trace import _trace_level, trace_streamlines
    st = AmrState.from_plotfile(
        plt, names=["x_velocity", "y_velocity", "z_velocity"],
        dtype=np.float32)
    ds = DenseAmrState.from_batched(st)
    fin = ds.meta.n_levels - 1
    geom = ds.meta.geoms[fin]
    bbox = ds.lmeta[fin].bbox
    dx = np.array(geom.dx)
    plo = (np.array(geom.prob_lo)
           + (np.array(bbox.lo) - np.array(geom.domain.lo)) * dx)
    rng = np.random.default_rng(0)
    seeds = 0.5 + 0.12 * (rng.random((4096, 3)) - 0.5)
    s2 = jnp.asarray(np.concatenate([seeds, seeds]), jnp.float32)
    dirs = jnp.concatenate([jnp.ones((4096, 1)), -jnp.ones((4096, 1))])
    vec = ds.data[fin]
    args = (vec, vec[:0], jnp.asarray(plo, jnp.float32),
            jnp.asarray(dx, jnp.float32), float(0.5 * dx[0]), s2, 25, dirs)
    jax.block_until_ready(_trace_level(*args))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(_trace_level(*args))
        ts.append(time.perf_counter() - t0)
    log(f"XLA march (4096 seeds x 51 stations, finest level "
        f"{tuple(vec.shape[1:])}): warm {min(ts) * 1e3:.3f} ms "
        f"(min of 5; all {[round(t * 1e3, 3) for t in ts]})")
    trace_streamlines(ds, seeds, 51, 0.5, trace_field=None)
    t0 = time.perf_counter()
    lines = trace_streamlines(ds, seeds, 51, 0.5, trace_field=None)
    log(f"trace_streamlines 4096 seeds end to end, warm: "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    if not np.isfinite(lines).all():
        raise AssertionError("non-finite streamlines")


# -- four cards --------------------------------------------------------------

def compare_outputs(a: str, b: str, comps, rtol: float) -> float:
    """Max over comps of max|a-b| / max|a| on valid cells; both must be
    finite on every valid cell."""
    import numpy as np

    from peleanalysis_tpu.io.plotfile import PlotfileReader
    from peleanalysis_tpu.tools.compare_plts import _per_box_valid
    ra, rb = PlotfileReader(a), PlotfileReader(b)
    ia = [ra.var_index(c) for c in comps]
    ib_ = [rb.var_index(c) for c in comps]
    err = np.zeros(len(comps))
    amax = np.zeros(len(comps))
    for lev, ib, valid in _per_box_valid(ra):
        fa = ra.read_box(lev, ib, ia).astype(np.float64)
        fb = rb.read_box(lev, ib, ib_).astype(np.float64)
        for k in range(len(comps)):
            va, vb = fa[k][valid], fb[k][valid]
            if not (np.isfinite(va).all() and np.isfinite(vb).all()):
                raise AssertionError(f"{a} or {b}:{comps[k]} not finite")
            err[k] = max(err[k], np.abs(va - vb).max())
            amax[k] = max(amax[k], np.abs(va).max())
    rel = float((err / np.maximum(amax, 1e-30)).max())
    if not rel < rtol:
        raise AssertionError(f"{b} vs {a}: rel {rel} >= {rtol}")
    return rel


def four_gpus(devs, n_cell: int, max_grid: int) -> None:
    """The four-card paths, cheapest first: the multi-device checks of
    ``dryrun_multichip(4)``, the placement of sharded grad and curvature
    outputs, then grad and curvature, and last the isosurface, each with
    ``ndevices=4`` (X slabs and a 2x2 mesh) against one card."""
    import numpy as np

    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.amr.hierarchy import AmrState
    from peleanalysis_tpu.io.mef import read_mef
    from peleanalysis_tpu.parallel.dense_shard import (make_spatial_mesh,
                                                       shard_dense_state)
    from peleanalysis_tpu.tools.curvature import compute_curvature_dense
    from peleanalysis_tpu.tools.grad import compute_grad_dense

    t0 = time.perf_counter()
    sys.path.insert(0, HERE)
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(4)
    log(f"dryrun_multichip(4): {time.perf_counter() - t0:.3f} s")

    plt = os.path.abspath("plt")
    write_plotfile(plt, n_cell, max_grid)
    # the outputs of the sharded library calls live on all four cards
    ds = DenseAmrState.from_batched(AmrState.from_plotfile(
        plt, names=["temp"], dtype=np.float32))
    for shape in (None, (2, 2)):
        t0 = time.perf_counter()
        sh = shard_dense_state(ds, make_spatial_mesh(4, shape))
        for name, out in (("grad", compute_grad_dense(sh, "temp")),
                          ("curvature",
                           compute_curvature_dense(sh, "temp"))):
            for lev, arr in enumerate(out.data):
                n = len(arr.sharding.device_set)
                assert n == 4, f"{name} lev{lev} on {n} devices"
        log(f"mesh {shape or '(4,) x-slabs'}: grad and curvature outputs "
            f"on 4 devices at every level ({time.perf_counter() - t0:.3f} s)")
    del ds, sh, out
    for d in devs[:4]:
        log(f"peak device memory {d}: {peak_bytes(d)} bytes")

    meshes = (("slab", ["ndevices=4"]),
              ("mesh22", ["ndevices=4", "mesh_shape=2 2"]))
    # tolerances of __graft_entry__.dryrun_multichip
    for tool, out, comps, rtol in (
            ("grad", "g", ["temp_gx", "temp_gy", "temp_gz",
                           "||gradtemp||"], 1e-5),
            ("curvature", "K", ["MeanCurvature_temp",
                                "GaussianCurvature_temp"], 5e-5)):
        key = "gradVar" if tool == "grad" else "progressName"
        for tag, extra in (("one", []),) + meshes:
            argv = [tool, f"infile={plt}", f"{key}=temp",
                    f"outfile={tag}_{out}"] + extra
            log(f"{tag} {tool}: {cli(argv):.3f} s")
            if tag != "one":
                rel = compare_outputs(f"one_{out}", f"{tag}_{out}", comps,
                                      rtol)
                log(f"{tag} {tool} == 1 card: rel {rel:.3e}")

    for tag, extra in (("one", []), meshes[1], meshes[0]):
        argv = ["isosurface", f"infile={plt}", "isoCompName=temp",
                f"isoVal={ISO_VAL}", f"outfile_base={tag}_iso"] + extra
        log(f"{tag} isosurface: {cli(argv):.3f} s")
        iso = read_mef(f"{tag}_iso.mef")
        if tag == "one":
            ref_iso = iso
            continue
        assert iso.n_nodes == ref_iso.n_nodes > 0, (iso.n_nodes,
                                                    ref_iso.n_nodes)
        assert np.array_equal(iso.elements, ref_iso.elements)
        assert np.allclose(iso.nodes, ref_iso.nodes, atol=1e-5)
        log(f"{tag} isosurface == 1 card: {iso.n_nodes} nodes, identical "
            "topology")
    for d in devs[:4]:
        log(f"peak device memory {d}: {peak_bytes(d)} bytes")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card paths")
    a = ap.parse_args()
    count = 4 if a.four_gpus else 1
    t_start = time.perf_counter()
    card_check(count)
    if not a.four_gpus:
        gpu_tests()
    devs = open_device(count)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    cwd = os.getcwd()
    try:
        os.chdir(work)
        if a.four_gpus:
            four_gpus(devs, N_CELL, MAX_GRID)
        else:
            main_path(devs[0], N_CELL, MAX_GRID)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
