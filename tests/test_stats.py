import os

import numpy as np
import pytest

from peleanalysis_tpu.amr.dense import DenseAmrState
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools.conditional_mean import (
    accumulate_conditional_mean, refinement_weights)
from peleanalysis_tpu.tools.integral import integrate_along
from peleanalysis_tpu.tools.jpdf import compute_jpdf_pair, normalize_pair
from peleanalysis_tpu.tools.rms_vel import rms_velocity


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("plts") / "plt")
    write_synthetic_plotfile(path, n_cell=32, n_levels=3)
    return DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float64))


def test_refinement_weights():
    assert refinement_weights([2, 2], 3) == [64, 8, 1]
    assert refinement_weights([2, 4], 3) == [8 * 64, 64, 1]


def test_conditional_mean_constant_field(ds):
    # binning a field by itself: avg in each bin must equal bin-sample values
    hits, sums, sumsq, mn, mx = accumulate_conditional_mean(
        ds, "temp", ["temp"], nbins=16, bin_min=300.0, bin_max=1800.0)
    total_w = hits.sum()
    # total weight = number of finest-equivalent cells with temp in range
    # temp in [300, 1800] never reaches 1800 exactly but min=300 at corners
    nf = 128 ** 3
    assert total_w <= nf
    assert total_w > 0.9 * nf
    avg = np.where(hits > 0, sums[:, 0] / np.maximum(hits, 1), 0)
    centers = 300 + (1800 - 300) / 16 * (0.5 + np.arange(16))
    sel = hits > 0
    # avg of temp conditioned on temp-bin must lie within the bin
    halfw = (1800 - 300) / 16 / 2
    assert np.all(np.abs(avg[sel] - centers[sel]) <= halfw + 1e-9)


def test_conditional_mean_vs_numpy(ds):
    # brute-force numpy check on a 2-level subset
    hits, sums, _, _, _ = accumulate_conditional_mean(
        ds, "progress", ["density"], nbins=8, bin_min=0.0, bin_max=1.0)
    w = refinement_weights(ds.meta.ref_ratio, ds.meta.n_levels)
    hits_np = np.zeros(8)
    sums_np = np.zeros(8)
    for lev in range(ds.meta.n_levels):
        p = np.asarray(ds.data[lev][ds.comp("progress")])
        d = np.asarray(ds.data[lev][ds.comp("density")])
        m = np.asarray(ds.valid_mask(lev))
        idx = np.floor(p * 8).astype(int)
        ok = m & (idx >= 0) & (idx < 8)
        np.add.at(hits_np, idx[ok], w[lev])
        np.add.at(sums_np, idx[ok], w[lev] * d[ok])
    np.testing.assert_allclose(hits, hits_np, rtol=1e-12)
    np.testing.assert_allclose(sums[:, 0], sums_np, rtol=1e-12)


def test_conditional_std_float32_no_cancellation(tmp_path):
    # ADVICE r1 (medium): with float32 accumulation, sumsq of a ~2000 K field
    # kept ~7 digits and the std column was rounding noise.  The shifted-
    # moment accumulation must recover a tiny std on a large-mean field.
    amp = 0.05
    fields = {
        "xcoord": lambda x, y, z: x,
        "bigtemp": lambda x, y, z: 2000.0 + amp * np.sin(2 * np.pi * y),
    }
    path = str(tmp_path / "plt")
    write_synthetic_plotfile(path, n_cell=16, n_levels=1, fields=fields)
    d32 = DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float32))
    hits, sums, sumsq, _, _ = accumulate_conditional_mean(
        d32, "xcoord", ["bigtemp"], nbins=4, bin_min=0.0, bin_max=1.0)
    mean = sums[:, 0] / hits
    var = sumsq[:, 0] / hits - mean ** 2
    std = np.sqrt(np.maximum(var, 0.0))
    # every x-bin sees the full y range: std = amp/sqrt(2) (discrete-sum
    # correction negligible at 16 samples)
    np.testing.assert_allclose(mean, 2000.0, rtol=1e-5)
    np.testing.assert_allclose(std, amp / np.sqrt(2), rtol=2e-2)


def test_conditional_mean_empty_selection_is_zero_not_nan(tmp_path):
    # r5 review fix: the 1e-300 divide guard underflows to 0.0 in float32,
    # so an empty bounds= selection made the moment shift 0/0 = NaN and
    # poisoned every output column
    path = str(tmp_path / "plt32")
    write_synthetic_plotfile(path, n_cell=16, n_levels=1)
    d32 = DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float32))
    hits, sums, sumsq, _, _ = accumulate_conditional_mean(
        d32, "temp", ["density"], nbins=4, bin_min=300.0, bin_max=1800.0,
        bounds=((2.0, 2.0, 2.0), (3.0, 3.0, 3.0)))   # outside the domain
    assert np.isfinite(hits).all() and np.isfinite(sums).all()
    assert np.isfinite(sumsq).all()
    assert hits.sum() == 0


def test_jpdf_mass_conservation(ds):
    f1 = [ds.data[l][ds.comp("temp")] for l in range(3)]
    f2 = [ds.data[l][ds.comp("progress")] for l in range(3)]
    b, bx1, bx2 = compute_jpdf_pair(ds, f1, f2, 300.0, 1801.0, -0.1, 1.1, 32)
    # clamped histogram: total volume = domain volume (all cells counted)
    np.testing.assert_allclose(b.sum(), 1.0, rtol=1e-10)
    bn, bx1n, bx2n, C1, C2 = normalize_pair(b, bx1, bx2, 300.0, 1801.0,
                                            -0.1, 1.1, 1.0)
    np.testing.assert_allclose(bn.sum(), 1.0, rtol=1e-10)
    # conditional means lie within their bins (where populated)
    nz = b > 0
    dv1 = (1801.0 - 300.0) / 32
    assert np.all(np.abs(bx1n[nz] - C1[nz]) <= dv1 / 2 + 1e-9)


def test_jpdf_multi_matches_per_pair(ds):
    # r5 (VERDICT r4 #6): the batched all-pairs kernel with shared one-hots
    # must reproduce the per-pair path for every pair of 3 variables
    from peleanalysis_tpu.tools.jpdf import compute_jpdf_pairs
    names = ["temp", "progress", "density"]
    flds = [[ds.data[l][ds.comp(n)] for l in range(3)] for n in names]
    lo = [300.0, -0.1, 0.05]
    hi = [1801.0, 1.1, 1.3]
    pairs = ((0, 1), (0, 2), (1, 2))
    bP, bx1P, bx2P = compute_jpdf_pairs(ds, flds, lo, hi, 24, pairs)
    assert bP.shape == (3, 24, 24)
    for p, (i, j) in enumerate(pairs):
        b, bx1, bx2 = compute_jpdf_pair(ds, flds[i], flds[j],
                                        lo[i], hi[i], lo[j], hi[j], 24)
        np.testing.assert_allclose(bP[p], b, rtol=1e-12, atol=1e-14)
        # bx columns carry the shifted-sum reconstruction; both paths use
        # the level-0 masked mean as shift, so they match to fp noise
        scale = np.maximum(np.abs(bx1).max(), 1e-30)
        np.testing.assert_allclose(bx1P[p], bx1, atol=2e-7 * scale)
        scale = np.maximum(np.abs(bx2).max(), 1e-30)
        np.testing.assert_allclose(bx2P[p], bx2, atol=2e-7 * scale)


def test_cli_jpdf_single_variable_no_pairs(tmp_path, monkeypatch):
    # r5 review fix: vars= with ONE variable has zero pairs — the batched
    # path must no-op cleanly (the reference loop was a clean no-op too)
    from peleanalysis_tpu.cli import main
    path = str(tmp_path / "plt1")
    write_synthetic_plotfile(path, n_cell=8, n_levels=1)
    monkeypatch.chdir(tmp_path)
    assert main(["jpdf", f"infile={path}", "vars=temp", "nBins=8",
                 "output_plotfile=0", "output_gnuplot=1"]) == 0


def test_integral_volume(ds):
    # integral of 1-like field: use density; compare against direct sum
    coords, w, fields = integrate_along(ds, ["density"], [0, 1, 2])
    assert abs(float(w) - 1.0) < 1e-12  # domain volume = 1
    direct = 0.0
    for lev in range(3):
        vol = float(np.prod(ds.meta.geoms[lev].dx))
        m = np.asarray(ds.valid_mask(lev))
        direct += np.sum(np.asarray(ds.data[lev][ds.comp("density")])[m]) * vol
    np.testing.assert_allclose(float(fields[0]), direct, rtol=1e-12)


def test_integral_along_one_dir(ds):
    coords, w, fields = integrate_along(ds, ["density"], [2])
    # column measure: every column spans the domain -> w == 1 everywhere
    np.testing.assert_allclose(w, 1.0, rtol=1e-12)
    assert fields[0].shape == (128, 128)
    # averaged version equals integral since w == 1
    _, _, favg = integrate_along(ds, ["density"], [2], avg=True)
    np.testing.assert_allclose(favg[0], fields[0], rtol=1e-12)


def test_integral_conditioned(ds):
    _, w_all, _ = integrate_along(ds, ["density"], [0, 1, 2])
    _, w_cond, _ = integrate_along(ds, ["density"], [0, 1, 2],
                                   c_name="progress", c_min=0.5, c_max=2.0)
    assert 0 < float(w_cond) < float(w_all)


def test_rms_velocity(ds):
    u = rms_velocity(ds)
    # analytic field: solid rotation + sin/cos perturbations on the fine
    # subregion; just sanity-bound it
    assert 0.01 < u < 1.0


def test_cli_conditional_mean(ds, tmp_path, monkeypatch):
    from peleanalysis_tpu.cli import main
    path = str(tmp_path / "plt")
    write_synthetic_plotfile(path, n_cell=16, n_levels=2)
    monkeypatch.chdir(tmp_path)
    rc = main(["conditionalMean", f"infile={path}", "binComp=progress",
               "avgComps=temp density", "nBins=8", "binMin=0", "binMax=1"])
    assert rc == 0
    assert os.path.exists(tmp_path / "CM_progress.dat")
    lines = open(tmp_path / "CM_progress.dat").read().splitlines()
    assert lines[0].startswith("VARIABLES = progress temp_sum density_sum")
    assert len(lines) == 2 + 8


def test_cli_jpdf(tmp_path, monkeypatch):
    from peleanalysis_tpu.cli import main
    path = str(tmp_path / "plt")
    write_synthetic_plotfile(path, n_cell=16, n_levels=2)
    monkeypatch.chdir(tmp_path)
    rc = main(["jpdf", f"infile={path}", "vars=temp progress", "nBins=16",
               "output_gnuplot=1", "output_plotfile=1"])
    assert rc == 0
    assert os.path.exists(path + "/Pdf_temp_progress.gpd")
    from peleanalysis_tpu.io.plotfile import PlotfileReader
    r = PlotfileReader(path + "/Pdf_temp_progress_plt")
    assert r.var_names == ["logpdf", "pdf"]


def test_cli_integral_and_rms(tmp_path, monkeypatch):
    from peleanalysis_tpu.cli import main
    path = str(tmp_path / "plt")
    write_synthetic_plotfile(path, n_cell=16, n_levels=2)
    monkeypatch.chdir(tmp_path)
    assert main(["integral", f"infile={path}", "vars=density",
                 "integralDimension=3"]) == 0
    assert os.path.exists(path + "_int.dat")
    assert main(["rmsVel", f"infile={path}"]) == 0
    assert os.path.exists(tmp_path / "RmsVel.dat")


def test_turbulence_spectrum_single_mode(tmp_path, monkeypatch):
    from peleanalysis_tpu.cli import main
    from peleanalysis_tpu.tools.turbulence_spectra import (energy_spectrum,
                                                           turbulence_stats)
    # single Fourier mode k=4: all energy in that shell
    n = 32
    x = (np.arange(n) + 0.5) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    u = np.sin(2 * np.pi * 4 * X)
    v = np.zeros_like(u)
    w = np.zeros_like(u)
    k, E = energy_spectrum(u, v, w)
    assert np.argmax(E) == 4
    assert E[4] / max(E.sum(), 1e-300) > 0.99
    # Parseval: sum(E) = 0.5*mean(u'^2) = 0.25
    np.testing.assert_allclose(E.sum(), 0.25, rtol=1e-6)
    st = turbulence_stats(u, v, w)
    np.testing.assert_allclose(st["urms"], np.sqrt(0.5), rtol=1e-6)

    fields = {
        "x_velocity": lambda x, y, z: np.sin(2 * np.pi * 4 * x),
        "y_velocity": lambda x, y, z: 0 * y,
        "z_velocity": lambda x, y, z: 0 * z,
    }
    plt = str(tmp_path / "plt")
    write_synthetic_plotfile(plt, n_cell=16, n_levels=1, fields=fields)
    monkeypatch.chdir(tmp_path)
    assert main(["turbulenceSpectra", f"infile={plt}",
                 "outfile_base=turb"]) == 0
    assert os.path.exists("turb_stats.dat")


def test_jpdf_conditioning_and_stoich(tmp_path, monkeypatch):
    from peleanalysis_tpu.cli import main
    fields = {
        "X(H2)": lambda x, y, z: 0.2 + 0.1 * x,
        "X(O2)": lambda x, y, z: 0.3 - 0.1 * x,
        "temp": lambda x, y, z: 300 + 1000 * x,
    }
    plt = str(tmp_path / "plt")
    write_synthetic_plotfile(plt, n_cell=8, n_levels=1, fields=fields)
    monkeypatch.chdir(tmp_path)
    # conditioning window on var 0 (X(H2) in [0.2, 0.25]) + stoichiometry
    rc = main(["jpdf", f"infile={plt}", "vars=X(H2) X(O2)", "nBins=8",
               "do_stoichiometry=1", "Hlist=2 0", "Olist=0 2",
               "do_conditioning=1", "cVar=0", "cMin=0.2", "cMax=0.25",
               "output_gnuplot=1", "output_plotfile=0"])
    assert rc == 0
    gpd = np.loadtxt(plt + "/Pdf_X(H2)_X(O2).gpd")
    # conditioned: total mass < 1 (only x in [0, .5] contributes)
    total = gpd[:, 2].sum()
    assert 0.3 < total < 0.7
    import os
    assert os.path.exists(plt + "/Pdf_X(H2)_Stoichiometry.gpd")


def test_jpdf_minmax_uncovered_only_deviation(tmp_path):
    """Documented deviation (docs/design.md): the jpdf /
    conditionalMean auto min/max scan uses UNCOVERED cells only, where the
    reference scans the whole domain including fine-covered coarse cells
    (jpdf.cpp:296-326).  Pin it: a spike planted in a covered coarse cell
    must not widen the scan."""
    import jax.numpy as jnp
    from peleanalysis_tpu.tools.jpdf import valid_minmax

    path = str(tmp_path / "plt")
    write_synthetic_plotfile(path, n_cell=16, n_levels=2)
    ds = DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float64))
    ic = ds.comp("temp")
    cov = np.asarray(ds.covered_mask(0))
    i, j, k = [int(v[0]) for v in np.nonzero(cov)]
    spiked = ds.data[0].at[ic, i, j, k].set(1.0e9)
    ds.data[0] = spiked
    lo, hi = valid_minmax(ds, ic)
    assert hi < 1.0e6, "covered-cell spike leaked into the min/max scan"
    assert 300.0 <= lo < hi <= 1801.0


def test_fused_stats_matches_standalone(ds):
    """accumulate_stats_fused == standalone condMean + jpdf (one dispatch +
    one fetch; numerics identical because the jitted accumulators inline)."""
    import numpy as np
    from peleanalysis_tpu.tools.conditional_mean import (
        accumulate_conditional_mean, accumulate_stats_fused)
    from peleanalysis_tpu.tools.jpdf import compute_jpdf_pair

    n_lev = ds.meta.n_levels
    (hits, sums, sumsq), (b, bx1, bx2) = accumulate_stats_fused(
        ds, "temp", ["density"], 32, 300.0, 1801.0,
        ("temp", "progress"), (300.0, 1801.0, -0.1, 1.1), 32)
    h0, s0, q0, _, _ = accumulate_conditional_mean(
        ds, "temp", ["density"], 32, 300.0, 1801.0)
    f1 = [ds.data[l][ds.comp("temp")] for l in range(n_lev)]
    f2 = [ds.data[l][ds.comp("progress")] for l in range(n_lev)]
    b0, bx10, bx20 = compute_jpdf_pair(ds, f1, f2, 300.0, 1801.0,
                                       -0.1, 1.1, 32)
    np.testing.assert_allclose(hits, h0, rtol=1e-12)
    np.testing.assert_allclose(sums, s0, rtol=1e-12)
    np.testing.assert_allclose(sumsq, q0, rtol=1e-12)
    np.testing.assert_allclose(b, b0, rtol=1e-12)
    np.testing.assert_allclose(bx1, bx10, rtol=1e-10)
    np.testing.assert_allclose(bx2, bx20, rtol=1e-10)
