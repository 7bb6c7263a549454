"""Cluster-axis SPMD (parallel/cluster_shard.py): canonical clusters batched
into one vmapped dispatch and sharded over a device mesh must reproduce the
serial per-cluster path exactly — the JAX analog of the reference's
DistributionMapping box->rank ownership (grad.cpp:160-163)."""
import numpy as np
import pytest

from peleanalysis_tpu.amr.box import Box, BoxArray
from peleanalysis_tpu.amr.geometry import Geometry
from peleanalysis_tpu.amr.hierarchy import AmrMeta, AmrState
from peleanalysis_tpu.testing import make_level_data


CENTERS = ((.25, .25, .25), (.75, .75, .75), (.25, .75, .5))


def _blob(x, y, z):
    out = 0.0
    for c in CENTERS:
        r = np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
        out = out + np.exp(-(r / 0.06) ** 2)
    return out


def _box_at(n, c, half):
    return Box(tuple(int((ci - half) * n) for ci in c),
               tuple(int((ci + half) * n) - 1 for ci in c))


@pytest.fixture(scope="module")
def scattered_state():
    """3 far-apart fine clusters, all deep enough inside the domain to be
    canonical-frame ELIGIBLE even at curvature's extra_margin=2 (clusters
    near the boundary fall back to the serial legacy path and would make
    the batched-parity tests vacuous — caught by a CLI verify drive)."""
    n0 = 64
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2), geom0.refine(2).refine(2)]
    ba1 = BoxArray([_box_at(128, c, .09) for c in CENTERS])
    ba2 = BoxArray([_box_at(256, c, .06) for c in CENTERS])
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1, ba2], [2, 2])
    names, data = make_level_data(geoms, meta.bas,
                                  {"blob": _blob,
                                   "xc": lambda x, y, z: x})
    return AmrState.from_arrays(meta, names, data, dtype=np.float64)


def _serial_outs(subs, infos, var="blob"):
    from peleanalysis_tpu.amr.canonical import global_frame
    from peleanalysis_tpu.tools.grad import compute_grad_dense

    return [global_frame(compute_grad_dense(s, var, interp="quadratic"),
                         i) for s, i in zip(subs, infos)]


def test_batched_grad_matches_serial(scattered_state):
    """Single-device batched dispatch == per-cluster serial engines."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates
    from peleanalysis_tpu.tools.grad import _grad_clusters_batched

    groups, subs, base, infos = canonical_cluster_substates(
        scattered_state, ngrow_max=1, interp_stencil=1)
    assert sum(1 for i in infos if i.canonical) >= 2
    ser = _serial_outs(subs, infos)
    bat = _grad_clusters_batched(subs, infos, "blob", None, "quadratic", 1)
    fin = scattered_state.meta.n_levels - 1
    for i, info in enumerate(infos):
        if not info.canonical:
            assert bat[i] is None
            continue
        m = np.asarray(subs[i].in_level_mask(fin))
        a = np.asarray(ser[i].data[fin])
        b = np.asarray(bat[i].data[fin])
        assert bat[i].names == ser[i].names
        np.testing.assert_allclose(a[:, m], b[:, m], rtol=1e-12, atol=1e-14)


def test_sharded_grad_matches_serial(scattered_state):
    """8-device cluster mesh: batch axis sharded, same numbers."""
    import jax

    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates
    from peleanalysis_tpu.tools.grad import _grad_clusters_batched

    assert len(jax.devices()) >= 8
    groups, subs, base, infos = canonical_cluster_substates(
        scattered_state, ngrow_max=1, interp_stencil=1)
    ser = _serial_outs(subs, infos)
    bat = _grad_clusters_batched(subs, infos, "blob", None, "quadratic", 8)
    fin = scattered_state.meta.n_levels - 1
    for i, info in enumerate(infos):
        if not info.canonical:
            continue
        m = np.asarray(subs[i].in_level_mask(fin))
        a = np.asarray(ser[i].data[fin])
        b = np.asarray(bat[i].data[fin])
        np.testing.assert_allclose(a[:, m], b[:, m], rtol=1e-12, atol=1e-14)


def test_sparse_iso_cluster_batch_parity(scattered_state):
    """Batched (and 8-device-sharded) enum extraction == the serial
    per-cluster sparse path: identical topology, nodes to f64 roundoff."""
    from peleanalysis_tpu.geom import marching_cubes as mc

    ref = mc.extract_isosurface_sparse(scattered_state, "blob", 0.5)
    bat = mc.extract_isosurface_sparse(scattered_state, "blob", 0.5,
                                       cluster_batch=True)
    shd = mc.extract_isosurface_sparse(scattered_state, "blob", 0.5,
                                       ndevices=8)
    assert ref.n_nodes > 100
    # the vmapped engine really ran (cache holds a "batched" key)
    assert any(k[1][0] == "batched" for k in mc._GLOBAL_ENUM_FNS
               if isinstance(k, tuple) and isinstance(k[1], tuple)
               and k[1]), "batched enum engine never built"
    for m in (bat, shd):
        assert m.n_nodes == ref.n_nodes
        np.testing.assert_array_equal(m.elements, ref.elements)
        np.testing.assert_allclose(m.nodes, ref.nodes, atol=1e-9)


def test_sparse_iso_mixed_buckets(tmp_path):
    """Clusters of DIFFERENT padded extents land in different canonical
    buckets: the batched path must run one vmapped engine per bucket and
    merge exactly with the serial result."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates
    from peleanalysis_tpu.geom import marching_cubes as mc

    n0 = 64
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2), geom0.refine(2).refine(2)]
    # small cluster (pads to 32) + large cluster (pads to 64)
    cs = [((.3, .3, .3), .05), ((.65, .65, .65), .12)]
    ba1 = BoxArray([_box_at(128, c, h + .03) for c, h in cs])
    ba2 = BoxArray([_box_at(256, c, h) for c, h in cs])
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1, ba2], [2, 2])
    names, data = make_level_data(geoms, meta.bas, {"blob": _blob})
    st = AmrState.from_arrays(meta, names, data, dtype=np.float64)
    _, subs, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=0)
    assert all(i.canonical for i in infos) and len(subs) == 2
    from peleanalysis_tpu.amr.dense import hier_fingerprint
    assert hier_fingerprint(subs[0]) != hier_fingerprint(subs[1]), \
        "clusters unexpectedly share a bucket — test is vacuous"
    ref = mc.extract_isosurface_sparse(st, "blob", 0.5)
    bat = mc.extract_isosurface_sparse(st, "blob", 0.5, cluster_batch=True)
    assert bat.n_nodes == ref.n_nodes > 100
    np.testing.assert_array_equal(bat.elements, ref.elements)
    np.testing.assert_allclose(bat.nodes, ref.nodes, atol=1e-9)


def test_sparse_iso_ndevices_beyond_host(scattered_state):
    """ndevices larger than the host's device count must pad the batch to
    the ACTUAL mesh size (cluster_mesh truncates to available devices) —
    a request-sized pad crashed device_put (review finding)."""
    from peleanalysis_tpu.geom import marching_cubes as mc

    ref = mc.extract_isosurface_sparse(scattered_state, "blob", 0.5)
    big = mc.extract_isosurface_sparse(scattered_state, "blob", 0.5,
                                       ndevices=12)   # host has 8
    assert big.n_nodes == ref.n_nodes
    np.testing.assert_array_equal(big.elements, ref.elements)


def _corner_plotfile(tmp_path):
    """3-level hierarchy whose fine clusters hug the domain corners: their
    canonical windows cross the boundary in every dim."""
    n0 = 48
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2), geom0.refine(2).refine(2)]
    cs = ((.1, .1, .1), (.9, .9, .9))
    ba1 = BoxArray([_box_at(96, c, .09) for c in cs])
    ba2 = BoxArray([_box_at(192, c, .06) for c in cs])
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1, ba2], [2, 2])
    names, data = make_level_data(geoms, meta.bas, {"blob": _blob})
    st = AmrState.from_arrays(meta, names, data, dtype=np.float64)
    plt = str(tmp_path / "plt_bd")
    st.to_plotfile(plt)
    return plt


def test_boundary_clusters_periodic_ndevices_wrap_spmd_exact(
        tmp_path, monkeypatch, capsys):
    """Corner clusters + PERIODIC boundaries + ndevices>1: round-4's
    wrap-cropped canonical frames serve the periodic window crossings
    (amr/canonical.py wrap_dims_for gates all pass — the fine boxes keep
    >=2 cells clear of every periodic face), so the clusters ride
    cluster-axis SPMD and match the dense run exactly.  grad defaults
    is_per=1 1 1."""
    from peleanalysis_tpu.cli import main

    plt = _corner_plotfile(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(["grad", f"infile={plt}", "gradVar=blob",
                 "outfile=g_bd", "ndevices=8", "dtype=float64"]) == 0
    seen = capsys.readouterr().out
    assert "2 canonical-frame" in seen
    assert "ndevices honored via the dense path" not in seen
    assert main(["grad", f"infile={plt}", "gradVar=blob",
                 "outfile=g_bd_ref", "force_dense=1", "dtype=float64"]) == 0
    assert main(["fcompare", "infile1=g_bd", "infile2=g_bd_ref",
                 "atol=1e-12"]) == 0
    g = AmrState.from_plotfile("g_bd")
    assert "||gradblob||" in g.names


def _face_hugging_plotfile(tmp_path):
    """3-level hierarchy with TWO scattered fine clusters (union bbox wide
    enough that needs_clustering fires), each TOUCHING a periodic domain
    face: the wrap-crop gate (>=2-cell clearance so the enum engine's seam
    key folding stays interior) rejects both, so every cluster is legacy."""
    n0 = 48
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2), geom0.refine(2).refine(2)]
    ba1 = BoxArray([Box((82, 2, 2), (95, 17, 17)),
                    Box((2, 78, 78), (17, 93, 95))])
    ba2 = BoxArray([Box((168, 8, 8), (191, 31, 31)),      # hi-x = dom hi
                    Box((8, 160, 160), (31, 183, 191))])  # hi-z = dom hi
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1, ba2], [2, 2])
    names, data = make_level_data(geoms, meta.bas, {"blob": _blob})
    st = AmrState.from_arrays(meta, names, data, dtype=np.float64)
    plt = str(tmp_path / "plt_face")
    st.to_plotfile(plt)
    return plt


def test_face_hugging_periodic_ndevices_falls_back_dense(
        tmp_path, monkeypatch, capsys):
    """A periodic-face-touching cluster has no wrap-croppable window (gate:
    <2 cells clearance), goes legacy, and the tools must honor ndevices>1
    via the dense spatial mesh — not silently run single-device."""
    from peleanalysis_tpu.cli import main

    plt = _face_hugging_plotfile(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(["grad", f"infile={plt}", "gradVar=blob",
                 "outfile=g_face", "ndevices=8"]) == 0
    assert main(["curvature", f"infile={plt}", "progressName=blob",
                 "outfile=K_face", "is_per=1 1 1", "ndevices=8"]) == 0
    seen = capsys.readouterr().out
    assert seen.count("ndevices honored via the dense path") == 2
    g = AmrState.from_plotfile("g_face")
    assert "||gradblob||" in g.names


def test_boundary_clusters_pinned_ndevices_spmd_exact(tmp_path, monkeypatch,
                                                      capsys):
    """Corner clusters + NON-periodic boundaries: pinned canonical frames
    ride the cluster-axis SPMD under ndevices>1, exactly matching the
    dense run (the round-3 behavior was a dense fallback at union-bbox
    HBM)."""
    from peleanalysis_tpu.cli import main

    plt = _corner_plotfile(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(["grad", f"infile={plt}", "gradVar=blob", "is_per=0 0 0",
                 "outfile=g_pin", "ndevices=8", "dtype=float64"]) == 0
    seen = capsys.readouterr().out
    assert "2 canonical-frame" in seen
    assert "ndevices honored via the dense path" not in seen
    assert main(["grad", f"infile={plt}", "gradVar=blob", "is_per=0 0 0",
                 "outfile=g_ref", "force_dense=1", "dtype=float64"]) == 0
    assert main(["fcompare", "infile1=g_pin", "infile2=g_ref",
                 "atol=1e-12"]) == 0


def test_sparse_stream_canonical_matches_dense(scattered_state):
    """Sparse streamline tracing through CANONICAL cluster frames (seeds
    translated into the window frame, lines translated back) == the dense
    union-bbox march, for fine-owned and coarse-owned seeds."""
    from peleanalysis_tpu.amr.canonical import canonical_cluster_substates
    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.stream.trace import (trace_streamlines,
                                               trace_streamlines_sparse)

    # the fixture's clusters sit deep inside the domain: they must be
    # canonical at the march's grow radius or this test is vacuous
    _, _, _, infos = canonical_cluster_substates(
        scattered_state, ngrow_max=5, interp_stencil=1, dist=6)
    assert all(i.canonical for i in infos)
    rng = np.random.default_rng(11)
    seeds = np.concatenate(
        [c + 0.06 * (rng.random((6, 3)) - 0.5) for c in CENTERS]
        + [np.stack([rng.uniform(0.45, 0.55, 6)] * 3, axis=1)])
    dense = DenseAmrState.from_batched(scattered_state)
    ref = trace_streamlines(dense, seeds, 11, 0.5, trace_field="blob",
                            sample_names=("xc",))
    got = trace_streamlines_sparse(scattered_state, seeds, 11, 0.5,
                                   trace_field="blob",
                                   sample_names=("xc",))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-11)


def test_cli_partstream_sparse_velocity_parity(tmp_path, monkeypatch,
                                               capsys):
    """partStream's sparse branch (velocity-mode trace through canonical
    cluster frames) == the dense union-bbox march, via the CLI."""
    from peleanalysis_tpu.cli import main

    n0 = 64
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2), geom0.refine(2).refine(2)]
    ba1 = BoxArray([_box_at(128, c, .09) for c in CENTERS])
    ba2 = BoxArray([_box_at(256, c, .06) for c in CENTERS])
    meta = AmrMeta(geoms, [BoxArray([dom0]), ba1, ba2], [2, 2])
    fields = {
        "x_velocity": lambda x, y, z: 0.4 + 0.3 * np.sin(2 * np.pi * y),
        "y_velocity": lambda x, y, z: 0.2 * np.cos(2 * np.pi * x),
        "z_velocity": lambda x, y, z: 0.1 + 0.0 * x,
    }
    names, data = make_level_data(geoms, meta.bas, fields)
    st = AmrState.from_arrays(meta, names, data, dtype=np.float64)
    plt = str(tmp_path / "plt_ps")
    st.to_plotfile(plt)
    monkeypatch.chdir(tmp_path)
    seed = " ".join(str(v) for v in CENTERS[0])
    base = ["partStream", f"infile={plt}", f"seedLoc={seed}",
            "Nsteps=21", "hRK=0.5"]
    assert main(base + ["outFile=ps_sp.dat"]) == 0
    assert "clustered path" in capsys.readouterr().out
    assert main(base + ["outFile=ps_de.dat", "force_dense=1"]) == 0
    sp = [l for l in open("ps_sp.dat") if not l.startswith("#")]
    de = [l for l in open("ps_de.dat") if not l.startswith("#")]
    assert sp == de


def test_cli_curvature_cluster_batch_parity(scattered_state, tmp_path,
                                            monkeypatch, capsys):
    """Sparse curvature via cluster-axis SPMD == the serial clustered
    path, end-to-end through the CLI plotfile writer."""
    from peleanalysis_tpu.cli import main

    plt = str(tmp_path / "plt_cv")
    scattered_state.to_plotfile(plt)
    monkeypatch.chdir(tmp_path)
    base = ["curvature", f"infile={plt}", "progressName=blob",
            "do_gaussCurv=1"]
    assert main(base + ["outfile=K_ser", "cluster_batch=0"]) == 0
    assert main(base + ["outfile=K_bat", "cluster_batch=1"]) == 0
    assert main(base + ["outfile=K_sh", "ndevices=8"]) == 0
    # the batched path must actually fire: every cluster canonical at
    # curvature's extra_margin=2 (a boundary-near fixture silently made
    # this test compare serial vs serial)
    seen = capsys.readouterr().out
    assert "3 canonical-frame" in seen
    ref = AmrState.from_plotfile("K_ser")
    assert f"MeanCurvature_blob" in ref.names
    for out in ("K_bat", "K_sh"):
        got = AmrState.from_plotfile(out)
        assert got.names == ref.names
        for lev in range(ref.meta.n_levels):
            # vmap changes FMA/reassociation in the lowered chain; the
            # ulp-level differences amplify through adj(H) cancellations
            # in GaussianCurvature (measured max rel ~1.2e-6 on 0.6% of
            # cells; grad, with no cancelling products, stays bit-exact)
            np.testing.assert_allclose(
                np.asarray(got.data[lev]), np.asarray(ref.data[lev]),
                rtol=1e-5, atol=1e-12)


def test_cli_grad_cluster_batch_parity(scattered_state, tmp_path,
                                       monkeypatch, capsys):
    """End-to-end CLI: sparse grad with cluster_batch=1 (and with
    ndevices=8) writes the same plotfile as the serial clustered path."""
    from peleanalysis_tpu.cli import main

    plt = str(tmp_path / "plt_sc")
    scattered_state.to_plotfile(plt)
    monkeypatch.chdir(tmp_path)
    assert main(["grad", f"infile={plt}", "gradVar=blob",
                 "outfile=g_ser", "cluster_batch=0"]) == 0
    assert main(["grad", f"infile={plt}", "gradVar=blob",
                 "outfile=g_bat", "cluster_batch=1"]) == 0
    assert main(["grad", f"infile={plt}", "gradVar=blob",
                 "outfile=g_sh", "ndevices=8"]) == 0
    assert "3 canonical-frame" in capsys.readouterr().out
    ref = AmrState.from_plotfile("g_ser")
    for out in ("g_bat", "g_sh"):
        got = AmrState.from_plotfile(out)
        assert got.names == ref.names
        for lev in range(ref.meta.n_levels):
            np.testing.assert_allclose(
                np.asarray(got.data[lev]), np.asarray(ref.data[lev]),
                rtol=1e-12, atol=1e-14)
