"""Cross-validation between the two compute engines (batched gather path vs
dense canonical path) and numpy reference implementations."""
import numpy as np
import pytest

from peleanalysis_tpu.amr.dense import DenseAmrState
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.ops.fill import get_fill_plan
from peleanalysis_tpu.reference_impl import numpy_curvature, numpy_grad_level
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools.curvature import compute_curvature_dense
from peleanalysis_tpu.tools.grad import compute_grad, compute_grad_dense


@pytest.fixture(scope="module")
def st(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("xe") / "plt")
    write_synthetic_plotfile(path, n_cell=16, n_levels=3)
    return AmrState.from_plotfile(path, dtype=np.float64)


def test_grad_batched_vs_dense(st):
    out_b = compute_grad(st, "temp")
    ds = DenseAmrState.from_batched(st)
    out_d = compute_grad_dense(ds, "temp")
    meta = st.meta
    for lev in range(meta.n_levels):
        ba = meta.bas[lev]
        bbox = ds.lmeta[lev].bbox
        dense = np.asarray(out_d.data[lev])
        batched = np.asarray(out_b.data[lev])
        for i, b in enumerate(ba):
            sl_d = tuple(slice(b.lo[d] - bbox.lo[d],
                               b.hi[d] - bbox.lo[d] + 1) for d in range(3))
            sl_b = tuple(slice(0, s) for s in b.shape)
            for c in range(1, 5):
                np.testing.assert_allclose(
                    dense[(c,) + sl_d], batched[(i, c) + sl_b],
                    rtol=1e-10, atol=1e-12)


def test_grad_dense_vs_numpy_reference(st):
    meta = st.meta
    ds = DenseAmrState.from_batched(st)
    out_d = compute_grad_dense(ds, "temp")
    ic = st.comp("temp")
    plans = []
    for lev in range(meta.n_levels):
        ba_c = meta.bas[lev - 1] if lev > 0 else None
        ps_c = meta.pad_shape(lev - 1) if lev > 0 else None
        ratio = meta.ref_ratio[lev - 1] if lev > 0 else 2
        plans.append(get_fill_plan(meta.bas[lev], meta.geoms[lev], 1,
                                   meta.pad_shape(lev), ba_c, ps_c, ratio,
                                   None, "linear"))
    np_data = [np.asarray(st.data[lev][:, ic : ic + 1])
               for lev in range(meta.n_levels)]
    for lev in range(meta.n_levels):
        ref = numpy_grad_level(plans[lev], np_data[lev],
                               np_data[lev - 1] if lev > 0 else None,
                               meta.geoms[lev].dx)
        ba = meta.bas[lev]
        bbox = ds.lmeta[lev].bbox
        dense = np.asarray(out_d.data[lev])
        for i, b in enumerate(ba):
            sl_d = tuple(slice(b.lo[d] - bbox.lo[d],
                               b.hi[d] - bbox.lo[d] + 1) for d in range(3))
            sl_b = tuple(slice(0, s) for s in b.shape)
            np.testing.assert_allclose(dense[(4,) + sl_d],
                                       ref[(i, 3) + sl_b],
                                       rtol=1e-10, atol=1e-12)


def test_curvature_dense_vs_numpy_reference(st):
    meta = st.meta
    ds = DenseAmrState.from_batched(st)
    out = compute_curvature_dense(ds, "progress", prog_min=0.0, prog_max=1.0,
                                  do_gauss=True)
    ip = st.comp("progress")
    plans = []
    for lev in range(meta.n_levels):
        ba_c = meta.bas[lev - 1] if lev > 0 else None
        ps_c = meta.pad_shape(lev - 1) if lev > 0 else None
        ratio = meta.ref_ratio[lev - 1] if lev > 0 else 2
        plans.append(get_fill_plan(meta.bas[lev], meta.geoms[lev], 1,
                                   meta.pad_shape(lev), ba_c, ps_c, ratio,
                                   None, "linear"))
    np_data = [np.asarray(st.data[lev][:, ip : ip + 1])
               for lev in range(meta.n_levels)]
    ref = numpy_curvature(plans, np_data,
                          [meta.geoms[lev].dx for lev in range(meta.n_levels)])
    km_c = out.comp("MeanCurvature_progress")
    kg_c = out.comp("GaussianCurvature_progress")
    for lev in range(meta.n_levels):
        Km_ref, Kg_ref = ref[lev]
        ba = meta.bas[lev]
        bbox = ds.lmeta[lev].bbox
        dense_km = np.asarray(out.data[lev][km_c])
        dense_kg = np.asarray(out.data[lev][kg_c])
        for i, b in enumerate(ba):
            sl_d = tuple(slice(b.lo[d] - bbox.lo[d],
                               b.hi[d] - bbox.lo[d] + 1) for d in range(3))
            sl_b = (i, 0) + tuple(slice(0, s) for s in b.shape)
            np.testing.assert_allclose(dense_km[sl_d], Km_ref[sl_b],
                                       rtol=1e-8, atol=1e-8)
            np.testing.assert_allclose(dense_kg[sl_d],
                                       Kg_ref[(i,) + tuple(
                                           slice(0, s) for s in b.shape)],
                                       rtol=1e-8, atol=1e-6)


def test_curvature_float32_flat_region(tmp_path):
    """float32 curvature of temp, which rounds to exactly 300 K away from
    the ball, so |grad| is 0 there and the 1e-14 floor decides.  Every
    output is finite; where the field is flat the Gaussian curvature is 0,
    as the float64 reference gives on the same float32-rounded data; on
    cells with |grad| >= 1% of the level maximum Km and Kg agree with it to
    1e-4 and 1e-3 of the level's largest value (float32 second
    differences)."""
    path = str(tmp_path / "plt")
    write_synthetic_plotfile(path, n_cell=16, n_levels=3)
    st32 = AmrState.from_plotfile(path, dtype=np.float32)
    meta = st32.meta
    ds = DenseAmrState.from_batched(st32)
    out = compute_curvature_dense(ds, "temp", prog_min=300.0,
                                  prog_max=1800.0, use_file_minmax=False)
    assert out.data[0].dtype == np.float32
    it = st32.comp("temp")
    plans = []
    for lev in range(meta.n_levels):
        ba_c = meta.bas[lev - 1] if lev > 0 else None
        ps_c = meta.pad_shape(lev - 1) if lev > 0 else None
        ratio = meta.ref_ratio[lev - 1] if lev > 0 else 2
        plans.append(get_fill_plan(meta.bas[lev], meta.geoms[lev], 1,
                                   meta.pad_shape(lev), ba_c, ps_c, ratio,
                                   None, "linear"))
    prog = [(np.asarray(st32.data[lev][:, it : it + 1], np.float64) - 300.0)
            / 1500.0 for lev in range(meta.n_levels)]
    dxs = [meta.geoms[lev].dx for lev in range(meta.n_levels)]
    ref = numpy_curvature(plans, prog, dxs)
    km_c = out.comp("MeanCurvature_temp")
    kg_c = out.comp("GaussianCurvature_temp")
    n_flat = 0
    for lev in range(meta.n_levels):
        g = numpy_grad_level(plans[lev], prog[lev],
                             prog[lev - 1] if lev > 0 else None, dxs[lev])
        gmax = g[:, 3].max()
        bbox = ds.lmeta[lev].bbox
        for c, k, tol in ((km_c, 0, 1e-4), (kg_c, 1, 1e-3)):
            dense = np.asarray(out.data[lev][c], np.float64)
            err = scale = 0.0
            for i, b in enumerate(meta.bas[lev]):
                sl_d = tuple(slice(b.lo[d] - bbox.lo[d],
                                   b.hi[d] - bbox.lo[d] + 1)
                             for d in range(3))
                sl_b = tuple(slice(0, s) for s in b.shape)
                a = dense[sl_d]
                r = ref[lev][k][(i, 0) + sl_b if k == 0 else (i,) + sl_b]
                gm = g[(i, 3) + sl_b]
                assert np.isfinite(a).all(), (lev, c)
                if k == 1:
                    flat = gm == 0.0
                    n_flat += int(flat.sum())
                    np.testing.assert_array_equal(a[flat], r[flat])
                steep = gm >= 0.01 * gmax
                err = max(err, np.abs(a[steep] - r[steep]).max())
                scale = max(scale, np.abs(r[steep]).max())
            assert err <= tol * scale, (lev, c, err / scale)
    assert n_flat > 0
