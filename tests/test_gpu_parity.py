"""Parity of the device path on the GPU against the float64 references.

Marked ``gpu``; each test skips unless JAX's first device is a GPU (decided
in the ``gpu`` fixture, never at import).  Run on a machine with a card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

The hierarchy is the core case: a 3-level synthetic plotfile at
n_cell=64 (64^3 + 2 refined levels, about 2.25 M cells), loaded as float32
as the tools load it.  The CPU tests of the same engines compare float64
with float64 at 1e-10; here the device computes in float32, so each
tolerance below is the float32 error of that computation, with a margin,
and is far below the ~1e-3 relative error of a TF32 contraction.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    """Skip off the GPU; on it, run with x64 off, as the tools run (the
    suite's conftest turns it on for the CPU parity tests)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def core(gpu, tmp_path_factory):
    """(float32 AmrState, float64 host data by level [nbox, ncomp, *pad],
    float32 DenseAmrState) of the core hierarchy."""
    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.amr.hierarchy import AmrState
    from peleanalysis_tpu.testing import write_synthetic_plotfile
    path = str(tmp_path_factory.mktemp("core") / "plt")
    _, _, _, names, raw = write_synthetic_plotfile(
        path, n_cell=64, n_levels=3, max_grid_size=32)
    st32 = AmrState.from_plotfile(path, dtype=np.float32)
    meta = st32.meta
    host = []
    for lev in range(meta.n_levels):
        a = np.zeros((len(meta.bas[lev]), len(names)) + meta.pad_shape(lev))
        for i, f in enumerate(raw[lev]):
            a[(i, slice(None)) + tuple(slice(0, s) for s in f.shape[1:])] = f
        host.append(a)
    return st32, host, DenseAmrState.from_batched(st32)


def _plans(meta):
    from peleanalysis_tpu.ops.fill import get_fill_plan
    plans = []
    for lev in range(meta.n_levels):
        ba_c = meta.bas[lev - 1] if lev > 0 else None
        ps_c = meta.pad_shape(lev - 1) if lev > 0 else None
        ratio = meta.ref_ratio[lev - 1] if lev > 0 else 2
        plans.append(get_fill_plan(meta.bas[lev], meta.geoms[lev], 1,
                                   meta.pad_shape(lev), ba_c, ps_c, ratio,
                                   None, "linear"))
    return plans


def _box_pairs(ds, meta, lev):
    """(dense slice, batched box slice) for every box of a level."""
    bbox = ds.lmeta[lev].bbox
    for i, b in enumerate(meta.bas[lev]):
        yield (tuple(slice(b.lo[d] - bbox.lo[d], b.hi[d] - bbox.lo[d] + 1)
                     for d in range(3)),
               (i,) + tuple(slice(0, s) for s in b.shape))


def test_gpu_grad_matches_numpy(core):
    """Gradient and its magnitude on every level vs numpy_grad_level.
    Tolerance 2e-5 of the level's largest |component|: the float32 input
    (relative rounding 6e-8) differenced across two cells loses a factor
    of about (flame width / dx) ~ 50 in relative terms."""
    from peleanalysis_tpu.reference_impl import numpy_grad_level
    from peleanalysis_tpu.tools.grad import compute_grad_dense
    st32, host, ds = core
    meta = st32.meta
    out = compute_grad_dense(ds, "temp")
    plans = _plans(meta)
    ic = st32.comp("temp")
    raw = [h[:, ic:ic + 1] for h in host]
    worst = 0.0
    for lev in range(meta.n_levels):
        ref = numpy_grad_level(plans[lev], raw[lev],
                               raw[lev - 1] if lev > 0 else None,
                               meta.geoms[lev].dx)
        dense = np.asarray(out.data[lev], np.float64)
        for c in range(4):
            err = scale = 0.0
            for sd, sb in _box_pairs(ds, meta, lev):
                a = dense[(c + 1,) + sd]
                b = ref[sb[:1] + (c,) + sb[1:]]
                err = max(err, np.abs(a - b).max())
                scale = max(scale, np.abs(b).max())
            assert err <= 2e-5 * scale, (lev, c, err / scale)
            worst = max(worst, err / scale)
    print(f"\nparity grad: max rel err {worst:.3e} (tol 2e-5)")


def test_gpu_curvature_matches_numpy(core):
    """Mean and Gaussian curvature of the progress field vs
    numpy_curvature: finite on every valid cell, and compared on cells
    where |grad progress| is at least 1% of its level maximum (below that
    the float32 rounding of the field, not the method, sets the normal's
    direction).  Tolerances 1e-4 (Km) and 1e-3 (Kg) of the level's largest
    value:
    second differences of float32 data amplify the 6e-8 rounding by
    (1/dx)^2 against a curvature of order 1/(flame radius)."""
    from peleanalysis_tpu.reference_impl import numpy_curvature
    from peleanalysis_tpu.tools.curvature import compute_curvature_dense
    st32, host, ds = core
    meta = st32.meta
    out = compute_curvature_dense(ds, "progress", prog_min=0.0,
                                  prog_max=1.0, do_gauss=True)
    ip = st32.comp("progress")
    raw = [h[:, ip:ip + 1] for h in host]
    plans = _plans(meta)
    dxs = [meta.geoms[lev].dx for lev in range(meta.n_levels)]
    ref = numpy_curvature(plans, raw, dxs)
    worst = {}
    from peleanalysis_tpu.reference_impl import numpy_grad_level
    for lev in range(meta.n_levels):
        g = numpy_grad_level(plans[lev], raw[lev],
                             raw[lev - 1] if lev > 0 else None, dxs[lev])
        gmax = max(g[sb[:1] + (3,) + sb[1:]].max()
                   for _, sb in _box_pairs(ds, meta, lev))
        for name, k, tol in (("MeanCurvature_progress", 0, 1e-4),
                             ("GaussianCurvature_progress", 1, 1e-3)):
            dense = np.asarray(out.data[lev][out.comp(name)], np.float64)
            err = scale = 0.0
            for sd, sb in _box_pairs(ds, meta, lev):
                assert np.isfinite(dense[sd]).all(), (lev, name)
                keep = g[sb[:1] + (3,) + sb[1:]] >= 0.01 * gmax
                a = dense[sd][keep]
                b = ref[lev][k][sb[:1] + (0,) + sb[1:] if k == 0
                                else sb][keep]
                if a.size:
                    err = max(err, np.abs(a - b).max())
                    scale = max(scale, np.abs(b).max())
            assert err <= tol * scale, (lev, name, err / scale)
            worst[name] = max(worst.get(name, 0.0), err / scale)
    print("\nparity curvature: " + ", ".join(
        f"{k} max rel err {v:.3e}" for k, v in worst.items())
        + " (tol 1e-4, 1e-3)")


def test_gpu_isosurface_enum_matches_host_engine(core):
    """The enum engine on the card vs the host numpy engine
    (classify="numpy") on the same filled data: the same nodes, matched
    one to one within 1e-3 finest cells (the crossing is interpolated in
    float32 on the card, float64 on the host), and the same triangles."""
    from scipy.spatial import cKDTree

    from peleanalysis_tpu.geom.marching_cubes import extract_isosurface
    _, _, ds = core
    dev = extract_isosurface(ds, "temp", 1000.0, classify="enum")
    host = extract_isosurface(ds, "temp", 1000.0, classify="numpy")
    assert dev.n_nodes == host.n_nodes > 1000
    assert dev.n_elts == host.n_elts
    dxf = min(ds.meta.geoms[-1].dx)
    dist, match = cKDTree(host.nodes[:, :3]).query(dev.nodes[:, :3])
    assert dist.max() <= 1e-3 * dxf, dist.max() / dxf
    print(f"\nparity isosurface: {dev.n_nodes} nodes, {dev.n_elts} tris, "
          f"max node distance {dist.max() / dxf:.3e} finest cells "
          "(tol 1e-3)")
    assert len(np.unique(match)) == dev.n_nodes
    t_dev = np.sort(match[dev.elements], axis=1)
    t_host = np.sort(host.elements, axis=1)
    t_dev = t_dev[np.lexsort(t_dev.T[::-1])]
    t_host = t_host[np.lexsort(t_host.T[::-1])]
    np.testing.assert_array_equal(t_dev, t_host)


def test_gpu_streamlines_match_numpy_trace(core):
    """4096 velocity streamlines x 51 stations from the centre of the
    finest level vs numpy_trace (float64 RK4 on the same level data).
    Tolerance 1e-3 finest cells: float32 positions gain ~1e-7 relative per
    step over 25 steps; a TF32 trilinear contraction would turn the
    direction by ~1e-3 rad, 1e-2 cells over the half-line."""
    from peleanalysis_tpu.reference_impl import numpy_trace
    from peleanalysis_tpu.stream.trace import trace_streamlines
    _, _, ds = core
    meta = ds.meta
    fin = meta.n_levels - 1
    geom = meta.geoms[fin]
    rng = np.random.default_rng(0)
    seeds = 0.5 + 0.12 * (rng.random((4096, 3)) - 0.5)
    lines = trace_streamlines(ds, seeds, 51, 0.5, trace_field=None)
    vel = np.stack([np.asarray(ds.data[fin][ds.comp(n)], np.float64)
                    for n in ("x_velocity", "y_velocity", "z_velocity")])
    bbox = ds.lmeta[fin].bbox
    dx = np.array(geom.dx)
    plo = (np.array(geom.prob_lo)
           + (np.array(bbox.lo) - np.array(geom.domain.lo)) * dx)
    h = 0.5 * dx[0]
    fwd = numpy_trace(vel, plo, dx, seeds, 25, h)
    bwd = numpy_trace(-vel, plo, dx, seeds, 25, h)
    ref = np.concatenate([bwd[::-1][:-1], fwd], axis=0).transpose(1, 0, 2)
    dev = np.abs(lines[..., :3] - ref).max() / dx.min()
    print(f"\nparity stream: max station deviation {dev:.3e} finest cells "
          "(tol 1e-3)")
    assert dev <= 1e-3, dev


def test_gpu_statistics_match_add_at_oracle(core):
    """conditionalMean (temp bins, density and progress means) and the
    temp-progress jpdf over all levels vs the np.add.at oracles.  A cell
    whose float32 bin index rounds across an edge may change bins, so
    counts agree to 1e-4 of the total weight, and means and variances are
    compared in bins whose counts agree exactly: means to 1e-5 of the
    range of bin means, conditional variances to 1e-5 of its square
    (float32 accumulation of shifted moments gives ~2e-7 on the CPU; TF32
    rounds each value to ~5e-4)."""
    from peleanalysis_tpu.reference_impl import (numpy_binned_stats,
                                                 numpy_joint_pdf)
    from peleanalysis_tpu.tools.conditional_mean import (
        accumulate_conditional_mean, refinement_weights)
    from peleanalysis_tpu.tools.jpdf import compute_jpdf_pair
    _, _, ds = core
    meta = ds.meta
    avg = ["density", "progress"]
    hits, sums, sumsq, _, _ = accumulate_conditional_mean(
        ds, "temp", avg, 64, 300.0, 1801.0)
    f1 = [ds.data[l][ds.comp("temp")] for l in range(meta.n_levels)]
    f2 = [ds.data[l][ds.comp("progress")] for l in range(meta.n_levels)]
    b, bx1, bx2 = compute_jpdf_pair(ds, f1, f2, 300.0, 1801.0, -0.1, 1.1,
                                    64)
    w = refinement_weights(meta.ref_ratio, meta.n_levels)
    rh = np.zeros(64)
    rs = np.zeros((64, 2))
    rq = np.zeros((64, 2))
    rb = [np.zeros((64, 64)) for _ in range(3)]
    for lev in range(meta.n_levels):
        d = np.asarray(ds.data[lev], np.float64)
        m = np.asarray(ds.valid_mask(lev))
        t = d[ds.comp("temp")]
        h_, s_, q_ = numpy_binned_stats(
            t, d[[ds.comp(n) for n in avg]], w[lev], m, 300.0, 1801.0, 64)
        rh += h_
        rs += s_
        rq += q_
        vol = float(np.prod(meta.geoms[lev].dx))
        for acc, part in zip(rb, numpy_joint_pdf(
                t, d[ds.comp("progress")], vol, m, 300.0, 1801.0, -0.1,
                1.1, 64)):
            acc += part
    moved = np.abs(hits - rh).sum() / rh.sum()
    same = (hits == rh) & (rh > 0)
    mean, rmean = sums[same] / hits[same, None], rs[same] / rh[same, None]
    span = rmean.max(0) - rmean.min(0)
    e_mean = (np.abs(mean - rmean) / span).max()
    var = sumsq[same] / hits[same, None] - mean ** 2
    rvar = rq[same] / rh[same, None] - rmean ** 2
    e_var = (np.abs(var - rvar) / span ** 2).max()
    moved2 = np.abs(b - rb[0]).sum() / rb[0].sum()
    same2 = (b == rb[0]) & (rb[0] > 0)
    e_jp = max((np.abs(got[same2] / b[same2] - want[same2] / rb[0][same2])
                / span_).max()
               for got, want, span_ in ((bx1, rb[1], 1501.0),
                                        (bx2, rb[2], 1.2)))
    print(f"\nparity stats: moved weight {moved:.1e}/{moved2:.1e}, "
          f"cond. mean {e_mean:.3e}, cond. variance {e_var:.3e}, "
          f"jpdf means {e_jp:.3e} (tol 1e-4, 1e-5, 1e-5, 1e-5)")
    assert moved <= 1e-4 and moved2 <= 1e-4 and same.sum() > 32
    assert e_mean <= 1e-5 and e_var <= 1e-5 and e_jp <= 1e-5


def test_gpu_kinetics_rates_match_numpy(gpu, tmp_path):
    """Forward and reverse rates of progress of a 7-species mechanism over
    4096 states, jitted in float32 on the card vs numpy float64: rtol 1e-4
    (exp of a log-space sum of magnitude ~50 keeps ~1e-5 in float32; a
    TF32 lnC @ nu misses by ~1e-2)."""
    import jax
    import jax.numpy as jnp

    from peleanalysis_tpu.chem.kinetics import Kinetics, parse_chemkin
    from test_precision import MECH
    p = tmp_path / "mech.inp"
    p.write_text(MECH)
    sp, rxns, _ = parse_chemkin(str(p))
    kin = Kinetics(sp, rxns)
    rng = np.random.default_rng(0)
    T = rng.uniform(800, 2500, 4096)
    C = np.abs(rng.normal(1e-6, 5e-7, (4096, 7)))
    Qf, Qr = kin.qf_qr(T, C)
    f = jax.jit(lambda t, c: kin.qf_qr(t, c, xp=jnp))
    Qfj, Qrj = f(jnp.asarray(T, jnp.float32), jnp.asarray(C, jnp.float32))
    rel = np.abs(np.asarray(Qfj, np.float64) - Qf) / np.abs(Qf)
    print(f"\nparity kinetics: max rel err of Qf {rel.max():.3e} "
          "(tol 1e-4)")
    np.testing.assert_allclose(np.asarray(Qfj, np.float64), Qf, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(Qrj, np.float64), Qr, rtol=1e-4,
                               atol=1e-30)
