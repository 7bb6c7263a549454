"""Position-independent (canonical-frame) cluster engines (amr/canonical.py).

A sparse path whose graphs bake absolute positions compiles one engine PER
CLUSTER.  These tests pin the fix: equal-bucket interior clusters share ONE fingerprint
(=> one compiled engine via amr/dense.shared_engine) and the results stay
exactly equal to the global dense run.  Reference model: position-independent
per-box kernels, /root/reference/Src/grad.cpp:160-163.
"""
import numpy as np
import pytest

from peleanalysis_tpu.amr.box import Box, BoxArray
from peleanalysis_tpu.amr.dense import DenseAmrState, hier_fingerprint
from peleanalysis_tpu.amr.geometry import Geometry
from peleanalysis_tpu.amr.hierarchy import AmrMeta, AmrState
from peleanalysis_tpu.testing import make_level_data


def _field(x, y, z):
    v = 0.0
    for c in ((.25, .25, .25), (.65, .65, .65), (.7, .2, .45),
              (.2, .7, .72)):
        r = np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
        v = v + np.exp(-(r / 0.07) ** 2)
    return v


@pytest.fixture(scope="module")
def multi_cluster_state():
    """2 levels; four EQUAL 16^3 interior fine clusters (one shared bucket)
    scattered through a 128^3 fine index space."""
    n0 = 64
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2)]
    los = [(24, 24, 24), (75, 75, 75), (82, 18, 49), (18, 82, 85)]
    ba1 = BoxArray([Box(lo, tuple(l + 15 for l in lo)) for lo in los])
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1], [2])
    names, data = make_level_data(geoms, [BoxArray([dom0]), ba1],
                                  {"blob": _field,
                                   "xc": lambda x, y, z: x})
    return AmrState.from_arrays(meta, names, data, dtype=np.float64)


def _canon(m):
    n = np.round(m.nodes, 9)
    order = np.lexsort(n.T[::-1])
    rank = np.empty(len(n), np.int64)
    rank[order] = np.arange(len(n))
    tris = np.sort(rank[m.elements], axis=1)
    return n[order], tris[np.lexsort(tris.T[::-1])]


def test_equal_bucket_clusters_share_fingerprint(multi_cluster_state):
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates

    groups, subs, base, infos = canonical_cluster_substates(
        multi_cluster_state, ngrow_max=1, interp_stencil=0)
    assert len(groups) == 4
    assert all(i.canonical for i in infos)
    fps = {hier_fingerprint(s) for s in subs}
    assert len(fps) == 1, "equal-bucket clusters must share ONE fingerprint"
    # translations are recorded and distinct
    assert len({tuple(i.shift) for i in infos}) == 4


def test_canonical_iso_exact_and_one_engine(multi_cluster_state):
    """Sparse extraction == dense enum extraction node-for-node, and the
    four equal clusters add at most (probe + big) = 2 engines for their
    shared fingerprint — not one per cluster."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates
    from peleanalysis_tpu.geom import marching_cubes as mc

    ds = DenseAmrState.from_batched(multi_cluster_state)
    for iso in (0.5, 0.12):
        m_ref = mc.extract_isosurface(ds, "blob", iso, classify="enum")
        m_sp = mc.extract_isosurface_sparse(multi_cluster_state, "blob", iso)
        assert len(m_ref.nodes) == len(m_sp.nodes) > 100
        n1, t1 = _canon(m_ref)
        n2, t2 = _canon(m_sp)
        np.testing.assert_allclose(n1, n2, atol=1e-12)
        np.testing.assert_array_equal(t1, t2)
    _, subs, _, infos = canonical_cluster_substates(
        multi_cluster_state, ngrow_max=1, interp_stencil=0)
    fp = hier_fingerprint(subs[0])
    n_engines = sum(1 for (f, k) in mc._GLOBAL_ENUM_FNS if f == fp)
    assert n_engines <= 3, (
        f"{n_engines} engines for one cluster fingerprint — positions "
        "leaked into the graph (expected probe + <=2 cap variants)")


def test_canonical_grad_exact(multi_cluster_state, tmp_path, monkeypatch,
                              capsys):
    from peleanalysis_tpu.cli import main

    plt = str(tmp_path / "plt_mc")
    multi_cluster_state.to_plotfile(plt)
    monkeypatch.chdir(tmp_path)
    # force the sparse gate (the fixture is small; min_cells defaults 2^21)
    import peleanalysis_tpu.amr.cluster as cl
    monkeypatch.setattr(cl, "needs_clustering",
                        lambda ba, waste_factor=4.0, min_cells=0:
                        ba.minimal_box().size
                        > waste_factor * ba.total_cells())
    assert main(["grad", f"infile={plt}", "gradVar=blob",
                 "outfile=g_sp", "dtype=float64"]) == 0
    assert "4 canonical-frame" in capsys.readouterr().out
    assert main(["grad", f"infile={plt}", "gradVar=blob", "force_dense=1",
                 "outfile=g_dn", "dtype=float64"]) == 0
    assert main(["fcompare", "infile1=g_sp", "infile2=g_dn",
                 "atol=1e-12"]) == 0


def test_canonical_curvature_exact(multi_cluster_state, tmp_path,
                                   monkeypatch, capsys):
    from peleanalysis_tpu.cli import main

    plt = str(tmp_path / "plt_mcK")
    multi_cluster_state.to_plotfile(plt)
    monkeypatch.chdir(tmp_path)
    import peleanalysis_tpu.amr.cluster as cl
    monkeypatch.setattr(cl, "needs_clustering",
                        lambda ba, waste_factor=4.0, min_cells=0:
                        ba.minimal_box().size
                        > waste_factor * ba.total_cells())
    assert main(["curvature", f"infile={plt}", "progressName=blob",
                 "outfile=K_sp", "dtype=float64"]) == 0
    assert "4 canonical-frame" in capsys.readouterr().out
    assert main(["curvature", f"infile={plt}", "progressName=blob",
                 "force_dense=1", "outfile=K_dn", "dtype=float64"]) == 0
    assert main(["fcompare", "infile1=K_sp", "infile2=K_dn",
                 "rtol=1e-9"]) == 0


def _corner_state(periodic=False):
    """One fine cluster hugging the lo corner (its windows cross the
    domain boundary), one interior."""
    n0 = 32
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (periodic,) * 3)
    geoms = [geom0, geom0.refine(2)]
    ba1 = BoxArray([Box((0, 0, 0), (15, 15, 15)),        # touches lo corner
                    Box((24, 24, 24), (39, 39, 39))])    # interior
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1], [2])
    names, data = make_level_data(
        geoms, [BoxArray([dom0]), ba1],
        # corner blob at .05: its 0.5-contour CROSSES the lo domain faces,
        # so the pinned frame's dual-cell clipping at the true boundary is
        # exercised against the dense enum run's
        {"blob": lambda x, y, z: np.exp(
            -((x - .05) ** 2 + (y - .05) ** 2 + (z - .05) ** 2) / .004)
            + np.exp(-((x - .5) ** 2 + (y - .5) ** 2
                       + (z - .5) ** 2) / .004),
         "x_velocity": lambda x, y, z: 1.0 + 0.3 * np.sin(2 * np.pi * y),
         "y_velocity": lambda x, y, z: 0.4 * np.cos(2 * np.pi * x),
         "z_velocity": lambda x, y, z: 0.2 + 0.1 * x})
    return AmrState.from_arrays(meta, names, data, dtype=np.float64)


def test_boundary_cluster_pinned_exact():
    """A cluster hugging a NON-periodic domain boundary is canonicalized
    with the domain edge PINNED in the crossing dims (the BC lands exactly
    where the global fill's would); the iso extraction through the pinned
    frame matches the dense enum run exactly."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates
    from peleanalysis_tpu.geom import marching_cubes as mc

    st = _corner_state(periodic=False)
    _, subs, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=0)
    assert [i.canonical for i in infos] == [True, True]
    # the pinned signature differs from the interior one -> separate engine
    corner = next(s for s, i in zip(subs, infos)
                  if s.meta.geoms[0].domain != s.lmeta[0].bbox)
    dom_c, W0 = corner.meta.geoms[0].domain, corner.lmeta[0].bbox
    assert W0.contains_box(dom_c) and dom_c != W0
    ds = DenseAmrState.from_batched(st)
    m_ref = mc.extract_isosurface(ds, "blob", 0.5, classify="enum")
    m_sp = mc.extract_isosurface_sparse(st, "blob", 0.5)
    n1, t1 = _canon(m_ref)
    n2, t2 = _canon(m_sp)
    np.testing.assert_allclose(n1, n2, atol=1e-12)
    np.testing.assert_array_equal(t1, t2)


def test_boundary_cluster_pinned_grad_exact():
    """grad through a pinned corner frame == the dense global run on every
    valid fine cell (the BC at the pinned edge must land exactly where the
    global fill's does)."""
    from peleanalysis_tpu.amr.canonical import (canonical_cluster_substates,
                                                global_frame)
    from peleanalysis_tpu.tools.grad import compute_grad_dense

    st = _corner_state(periodic=False)
    ds = DenseAmrState.from_batched(st)
    ref = compute_grad_dense(ds, "blob", interp="quadratic")
    groups, subs, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=1)
    assert all(i.canonical for i in infos)
    rb = ref.lmeta[1].bbox
    boxes = list(st.meta.bas[1])

    def fab(src, bbox, b, comp):
        sl = tuple(slice(b.lo[d] - bbox.lo[d], b.hi[d] - bbox.lo[d] + 1)
                   for d in range(3))
        return np.asarray(src.data[1][comp][sl])

    for g, sub, info in zip(groups, subs, infos):
        out = global_frame(compute_grad_dense(sub, "blob",
                                              interp="quadratic"), info)
        for bi in g:
            a = fab(out, out.lmeta[1].bbox, boxes[bi],
                    out.comp("||gradblob||"))
            b = fab(ref, rb, boxes[bi], ref.comp("||gradblob||"))
            np.testing.assert_allclose(a, b, atol=1e-12)


def test_boundary_cluster_pinned_curvature_exact():
    """The 13-field curvature chain through a pinned corner frame == the
    dense run (chained stencil stages read deepest into the BC layers —
    the sharpest test of pinned-edge placement)."""
    from peleanalysis_tpu.amr.canonical import (canonical_cluster_substates,
                                                global_frame)
    from peleanalysis_tpu.tools.curvature import compute_curvature_dense

    st = _corner_state(periodic=False)
    ds = DenseAmrState.from_batched(st)
    kw = dict(do_smooth=False, do_gauss=True, prog_min=0.0, prog_max=1.0,
              use_file_minmax=False)
    ref = compute_curvature_dense(ds, "blob", **kw)
    groups, subs, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=1, extra_margin=2)
    assert all(i.canonical for i in infos)
    rb = ref.lmeta[1].bbox
    boxes = list(st.meta.bas[1])
    for g, sub, info in zip(groups, subs, infos):
        out = global_frame(compute_curvature_dense(sub, "blob", **kw), info)
        wb = out.lmeta[1].bbox
        for name in ("MeanCurvature_blob", "GaussianCurvature_blob"):
            ci, co = ref.comp(name), out.comp(name)
            for bi in g:
                bx = boxes[bi]
                slw = tuple(slice(bx.lo[d] - wb.lo[d],
                                  bx.hi[d] - wb.lo[d] + 1) for d in range(3))
                slr = tuple(slice(bx.lo[d] - rb.lo[d],
                                  bx.hi[d] - rb.lo[d] + 1) for d in range(3))
                a = np.asarray(out.data[1][co])[slw]
                b = np.asarray(ref.data[1][ci])[slr]
                assert np.isfinite(a).all() and np.isfinite(b).all(), name
                scale = max(np.abs(b).max(), 1e-30)
                assert np.abs(a - b).max() / scale < 1e-12, name


def test_boundary_cluster_pinned_stream_exact():
    """Sparse streamline tracing through a pinned corner frame == the dense
    march, including lines that clamp at the true domain boundary."""
    from peleanalysis_tpu.stream.trace import (trace_streamlines,
                                               trace_streamlines_sparse)

    st = _corner_state(periodic=False)
    rng = np.random.default_rng(3)
    # seeds inside the corner cluster (near the boundary) + interior ones
    seeds = np.concatenate([
        rng.uniform(0.03, 0.2, (8, 3)),
        0.5 + 0.06 * (rng.random((6, 3)) - 0.5)])
    ds = DenseAmrState.from_batched(st)
    ref = trace_streamlines(ds, seeds, 15, 0.5, trace_field=None)
    sp = trace_streamlines_sparse(st, seeds, 15, 0.5, trace_field=None)
    np.testing.assert_allclose(sp, ref, atol=1e-9)


def test_sparse_stream_seed_counts_bucketed(multi_cluster_state,
                                            monkeypatch):
    """r5: per-cluster seed COUNT is a compile shape too — canonical
    clusters must pad their seed batches to shared power-of-two buckets
    (bench r5 caught 12 per-cluster march compiles at scattered-512^3),
    and the padded march must still return the exact unpadded lines."""
    import peleanalysis_tpu.stream.trace as tr

    st = multi_cluster_state
    rng = np.random.default_rng(7)
    # deliberately unequal per-cluster seed counts (5 / 9 / 17 seeds) in
    # three of the four clusters + a few coarse-owned seeds
    centers = [(0.25, 0.25, 0.25), (0.65, 0.65, 0.65), (0.70, 0.20, 0.45)]
    seeds = np.concatenate(
        [np.asarray(c) + 0.05 * (rng.random((n, 3)) - 0.5)
         for c, n in zip(centers, (5, 9, 17))]
        + [np.array([[0.45, 0.45, 0.1]]) + 0.01 * rng.random((3, 3))])

    calls = []
    orig = tr.trace_streamlines

    def spy(ds, s, *a, **kw):
        calls.append(len(s))
        return orig(ds, s, *a, **kw)

    monkeypatch.setattr(tr, "trace_streamlines", spy)
    sp = tr.trace_streamlines_sparse(st, seeds, 11, 0.5,
                                     trace_field="blob")
    monkeypatch.undo()
    # every canonical-cluster march saw the SAME padded bucket (>= 64)
    cluster_counts = [c for c in calls if c >= 64 and (c & (c - 1)) == 0]
    assert len(cluster_counts) == 3, calls
    assert len(set(cluster_counts)) == 1, calls
    # and the padding is invisible in the result: dense parity
    ref = tr.trace_streamlines(DenseAmrState.from_batched(st), seeds, 11,
                               0.5, trace_field="blob")
    np.testing.assert_allclose(sp, ref, atol=1e-9)


def test_boundary_cluster_anchored_shared_signature():
    """Two clusters along the SAME domain face at different offsets share
    one anchored signature (one engine); a corner cluster gets its own."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates
    from peleanalysis_tpu.amr.dense import hier_fingerprint

    n0 = 48
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2)]
    # x-lo face at two different offsets/y-positions + an x-lo corner
    # (y/z stay deep interior so only the x pattern crosses)
    ba1 = BoxArray([Box((2, 24, 24), (13, 35, 35)),     # x-lo, offset 2
                    Box((6, 52, 52), (17, 63, 63)),     # x-lo, offset 6
                    Box((0, 0, 0), (11, 11, 11))])      # lo corner
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1], [2])
    names, data = make_level_data(geoms, meta.bas,
                                  {"f": lambda x, y, z: x * y + z})
    st = AmrState.from_arrays(meta, names, data, dtype=np.float64)
    _, subs, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=1, extra_margin=2)
    assert all(i.canonical for i in infos)
    fps = [hier_fingerprint(s) for s in subs]
    # 2 signatures for 3 clusters: the two face clusters share one engine
    # (cluster_boxes orders groups arbitrarily — compare as a multiset)
    from collections import Counter
    assert sorted(Counter(fps).values()) == [1, 2]


def test_boundary_cluster_whole_domain_dim_exact():
    """A cluster spanning (nearly) the whole domain in one dim: the frame
    anchors at both edges; grad through it == dense."""
    from peleanalysis_tpu.amr.canonical import (canonical_cluster_substates,
                                                global_frame)
    from peleanalysis_tpu.tools.grad import compute_grad_dense

    n0 = 16
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2)]
    ba1 = BoxArray([Box((0, 8, 8), (31, 19, 19))])   # full x span
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1], [2])
    names, data = make_level_data(
        geoms, meta.bas,
        {"f": lambda x, y, z: np.sin(3 * x) + y * y + 0.5 * z})
    st = AmrState.from_arrays(meta, names, data, dtype=np.float64)
    _, subs, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=1)
    assert all(i.canonical for i in infos)
    ds = DenseAmrState.from_batched(st)
    ref = compute_grad_dense(ds, "f", interp="quadratic")
    out = global_frame(compute_grad_dense(subs[0], "f", interp="quadratic"),
                       infos[0])
    b0 = ba1[0]
    rb, wb = ref.lmeta[1].bbox, out.lmeta[1].bbox
    sl_r = tuple(slice(b0.lo[d] - rb.lo[d], b0.hi[d] - rb.lo[d] + 1)
                 for d in range(3))
    sl_w = tuple(slice(b0.lo[d] - wb.lo[d], b0.hi[d] - wb.lo[d] + 1)
                 for d in range(3))
    c = ref.comp("||gradf||")
    np.testing.assert_allclose(np.asarray(out.data[1][out.comp("||gradf||")])[sl_w],
                               np.asarray(ref.data[1][c])[sl_r], atol=1e-12)


def test_boundary_cluster_periodic_falls_back_legacy():
    """Crossing a PERIODIC boundary cannot be served from a window (the
    wrap needs the opposite side of the domain) -> legacy exact path."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates

    st = _corner_state(periodic=True)
    _, _, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=0)
    assert sorted(i.canonical for i in infos) == [False, True]


def test_canonical_substates_cached_on_state(multi_cluster_state):
    """Warm re-runs reuse the substates (window crops, masks, caps) via the
    state-held LRU cache; distinct parameter keys evict past 4 entries."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates

    st = multi_cluster_state
    a = canonical_cluster_substates(st, ngrow_max=1, interp_stencil=1)
    b = canonical_cluster_substates(st, ngrow_max=1, interp_stencil=1)
    assert b[1][0] is a[1][0], "second call must reuse cached substates"
    for g in (2, 3, 4, 5):     # 4 distinct keys push the first one out
        canonical_cluster_substates(st, ngrow_max=g, interp_stencil=1)
    c = canonical_cluster_substates(st, ngrow_max=1, interp_stencil=1)
    assert c[1][0] is not a[1][0], "LRU(4) should have evicted the entry"


def test_canonical_2d_exact_z_frames(tmp_path):
    """DIM=2 states: frames carry the EXACT fine z extent (no z bucketing)
    with both z edges pinned, so scattered 2-D clusters canonicalize and
    share engines; grad through them == the dense 2-D run.  The state
    round-trips through a REAL 2-D plotfile (promote_2d gives every level
    z extent 1 and an unrefined z — the form that exposed the gz!=0 bug
    when canonical geoms blindly refined z)."""
    from peleanalysis_tpu.amr.canonical import (canonical_cluster_substates,
                                                global_frame)
    from peleanalysis_tpu.amr.dense import hier_fingerprint
    from peleanalysis_tpu.tools.grad import compute_grad_dense

    n0 = 64
    dom0 = Box((0, 0, 0), (n0 - 1, n0 - 1, 0))
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1. / n0), (False,) * 3)
    geoms = [geom0, geom0.refine(2)]
    # both deep interior (a 32-granule frame near the edge slides flush and
    # legitimately becomes a pinned-hi signature — that case is 3-D-tested)
    ba1 = BoxArray([Box((16, 16, 0), (27, 27, 1)),
                    Box((80, 80, 0), (91, 91, 1))])
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1], [2], ndim2=True)
    names, data = make_level_data(geoms, meta.bas,
                                  {"f": lambda x, y, z: x * x + y})
    st0 = AmrState.from_arrays(meta, names, data, dtype=np.float64)
    plt = str(tmp_path / "plt2d_canon")
    st0.to_plotfile(plt)
    st = AmrState.from_plotfile(plt, dtype=np.float64)
    assert st.meta.geoms[1].domain.shape[2] == 1   # promote_2d: unrefined z
    ba1 = st.meta.bas[1]
    groups, subs, base, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=1)
    assert len(subs) == 2
    assert all(i.canonical for i in infos)
    # z is never bucket-padded: the frame depth equals the fine z extent
    assert all(s.lmeta[1].bbox.shape[2] == 1 for s in subs)
    assert hier_fingerprint(subs[0]) == hier_fingerprint(subs[1])
    ds = DenseAmrState.from_batched(st)
    ref = compute_grad_dense(ds, "f", interp="quadratic")
    rb = ref.lmeta[1].bbox
    boxes = list(ba1)
    for g, sub, info in zip(groups, subs, infos):
        out = global_frame(compute_grad_dense(sub, "f",
                                              interp="quadratic"), info)
        wb = out.lmeta[1].bbox
        for bi in g:
            bx = boxes[bi]
            slw = tuple(slice(bx.lo[d] - wb.lo[d], bx.hi[d] - wb.lo[d] + 1)
                        for d in range(3))
            slr = tuple(slice(bx.lo[d] - rb.lo[d], bx.hi[d] - rb.lo[d] + 1)
                        for d in range(3))
            a = np.asarray(out.data[1][out.comp("||gradf||")])[slw]
            b = np.asarray(ref.data[1][ref.comp("||gradf||")])[slr]
            np.testing.assert_allclose(a, b, atol=1e-12)


def test_canonical_2d_sparse_stream_exact(tmp_path):
    """2-D sparse streamline tracing through canonical frames == the dense
    march (2-column seeds promote to the z center; this path crashed on
    unpromoted seeds before r4)."""
    from peleanalysis_tpu.stream.trace import (trace_streamlines,
                                               trace_streamlines_sparse)

    n0 = 64
    dom0 = Box((0, 0, 0), (n0 - 1, n0 - 1, 0))
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1. / n0), (False,) * 3)
    geoms = [geom0, geom0.refine(2)]
    ba1 = BoxArray([Box((16, 16, 0), (27, 27, 1)),
                    Box((80, 80, 0), (91, 91, 1))])
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1], [2], ndim2=True)
    names, data = make_level_data(
        geoms, meta.bas,
        {"temp": lambda x, y, z: 300 + 1500 * np.exp(
            -((x - .35) ** 2 + (y - .35) ** 2) / .01)})
    plt = str(tmp_path / "plt2d_stream")
    AmrState.from_arrays(meta, names, data, dtype=np.float64).to_plotfile(plt)
    st = AmrState.from_plotfile(plt, dtype=np.float64)
    rng = np.random.default_rng(9)
    seeds = np.concatenate([
        np.stack([rng.uniform(0.26, 0.42, 8),
                  rng.uniform(0.26, 0.42, 8)], axis=1),
        np.stack([rng.uniform(0.1, 0.9, 6),
                  rng.uniform(0.1, 0.9, 6)], axis=1)])
    ref = trace_streamlines(DenseAmrState.from_batched(st), seeds, 15, 0.5,
                            trace_field="temp")
    sp = trace_streamlines_sparse(st, seeds, 15, 0.5, trace_field="temp")
    np.testing.assert_allclose(sp, ref, atol=1e-12)


def test_canonical_2d_periodic_xy_falls_back_legacy():
    """2-D clusters crossing a PERIODIC x/y boundary still fall back to
    the exact legacy path (extent > 1: wrap needs the opposite side)."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates

    n0 = 64
    dom0 = Box((0, 0, 0), (n0 - 1, n0 - 1, 0))
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1. / n0),
                     (True, True, False))
    geoms = [geom0, geom0.refine(2)]
    ba1 = BoxArray([Box((0, 0, 0), (11, 11, 1)),      # hugs periodic corner
                    Box((60, 60, 0), (71, 71, 1))])   # deep interior
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1], [2], ndim2=True)
    names, data = make_level_data(geoms, meta.bas,
                                  {"f": lambda x, y, z: x + y})
    st = AmrState.from_arrays(meta, names, data, dtype=np.float64)
    _, _, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=1)
    assert sorted(i.canonical for i in infos) == [False, True]


# ---------------------------------------------------------------------------
# Periodic window-crossing clusters: wrap-cropped canonical frames (r4)
# ---------------------------------------------------------------------------

def _periodic_state(gap=2):
    """Periodic-x/y domain; one fine cluster whose hi-x WINDOW crosses the
    periodic edge while its boxes keep ``gap`` fine cells clear of the
    face, one interior cluster of the SAME bucket extent (so the wrap
    cluster must share the interior engine)."""
    n0, R = 24, 2
    nf = n0 * R
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (True, True, False))
    geoms = [geom0, geom0.refine(R)]
    ext = 12
    ba1 = BoxArray([
        Box((nf - ext - gap, 20, 8), (nf - gap - 1, 20 + ext - 1,
                                      8 + ext - 1)),
        # same z band as the first cluster: the ONLY structural difference
        # between the two frames is x/y position, which wrap treatment
        # keeps out of the compile -> fingerprints must match
        Box((4, 4, 8), (4 + ext - 1, 4 + ext - 1, 8 + ext - 1))])
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1], [R])
    # steep bump near the hi-x edge + a LINEAR term discontinuous across
    # the wrap: any foextrap-instead-of-wrap ghost value shows up at
    # O(10*dx) in the gradient, far above the 1e-12 parity bar
    names, data = make_level_data(
        geoms, meta.bas,
        {"temp": lambda x, y, z: 300 + 1500 * np.exp(
            -((x - .85) ** 2 + (y - .45) ** 2 + (z - .3) ** 2) / .02)
            + 10 * x + 5 * y * z})
    return AmrState.from_arrays(meta, names, data, dtype=np.float64), ba1


def test_periodic_window_crossing_canonicalizes_exactly():
    """A cluster whose window reaches past a PERIODIC edge (boxes >= 2
    cells clear of the face) is served by a wrap-cropped canonical frame:
    grad == dense at 1e-12 and the isosurface node/element sets are
    exactly the dense enum engine's (which folds periodic-image keys)."""
    from peleanalysis_tpu.amr.canonical import (canonical_cluster_substates,
                                                global_frame)
    from peleanalysis_tpu.geom import marching_cubes as mc
    from peleanalysis_tpu.tools.grad import compute_grad_dense

    st, ba1 = _periodic_state()
    ds = DenseAmrState.from_batched(st)
    groups, subs, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=1)
    assert all(i.canonical for i in infos)
    assert any(0 in getattr(s, "_canon_wraps", ()) for s in subs), \
        "the hi-x cluster must be wrap-cropped along x"

    ref = compute_grad_dense(ds, "temp", interp="quadratic")
    rb = ref.lmeta[1].bbox
    c = ref.comp("||gradtemp||")
    boxes = list(ba1)
    for g, sub, info in zip(groups, subs, infos):
        out = global_frame(compute_grad_dense(sub, "temp",
                                              interp="quadratic"), info)
        wb = out.lmeta[1].bbox
        co = out.comp("||gradtemp||")
        for bi in g:
            bx = boxes[bi]
            slw = tuple(slice(bx.lo[d] - wb.lo[d],
                              bx.hi[d] - wb.lo[d] + 1) for d in range(3))
            slr = tuple(slice(bx.lo[d] - rb.lo[d],
                              bx.hi[d] - rb.lo[d] + 1) for d in range(3))
            np.testing.assert_allclose(np.asarray(out.data[1][co])[slw],
                                       np.asarray(ref.data[1][c])[slr],
                                       atol=1e-12, err_msg=f"box {bi}")

    m_ref = mc.extract_isosurface(ds, "temp", 800.0, classify="enum")
    m_sp = mc.extract_isosurface_sparse(st, "temp", 800.0)
    assert m_sp.n_nodes == m_ref.n_nodes

    def canon(m):
        n = np.asarray(m.nodes)
        e = np.asarray(m.elements)
        order = np.lexsort(n.T[::-1])
        inv = np.empty(len(n), np.int64)
        inv[order] = np.arange(len(n))
        tri = np.sort(inv[e - 1], axis=1)
        return n[order], tri[np.lexsort(tri.T[::-1])]

    n1, t1 = canon(m_ref)
    n2, t2 = canon(m_sp)
    np.testing.assert_allclose(n1, n2, atol=1e-12)
    np.testing.assert_array_equal(t1, t2)


def test_periodic_wrap_cluster_shares_interior_engine():
    """The wrap lives entirely in traced window DATA: a wrap cluster's
    canonical hierarchy is fingerprint-identical to an equal-bucket
    interior cluster's, so they share one compiled engine (the whole point
    — no per-position compile returns on periodic HIT-style cases)."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates

    st, _ = _periodic_state()
    _, subs, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=1)
    assert all(i.canonical for i in infos)
    fps = {hier_fingerprint(s) for s in subs}
    assert len(fps) == 1, "wrap + interior clusters must share one engine"


def test_periodic_face_touching_cluster_falls_back_legacy():
    """Fine boxes within 2 cells of a periodic face -> legacy (the dense
    enum engine folds node keys at the seam; a window cannot reproduce
    the fold)."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates

    st, _ = _periodic_state(gap=0)      # boxes touch the hi-x face
    _, subs, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=1)
    assert sorted(i.canonical for i in infos) == [False, True]


def test_periodic_stream_through_wrap_window_matches_dense():
    """Streamlines seeded in the wrap cluster march on wrapped ghost data
    exactly as the dense grow-box march does."""
    from peleanalysis_tpu.stream.trace import (trace_streamlines,
                                               trace_streamlines_sparse)

    st, _ = _periodic_state()
    seeds = np.array([[0.93, 0.48, 0.33], [0.90, 0.44, 0.31],
                      [0.91, 0.50, 0.35]])
    ref = trace_streamlines(DenseAmrState.from_batched(st), seeds, 13, 0.5,
                            trace_field="temp")
    sp = trace_streamlines_sparse(st, seeds, 13, 0.5, trace_field="temp")
    np.testing.assert_allclose(sp, ref, atol=1e-9)
