import numpy as np
import pytest

from peleanalysis_tpu.geom.sdf import (parity_sign, point_tri_distance,
                                       unsigned_distance_grid)
from test_mef_tools import make_sphere_mef


def test_point_tri_distance_regions():
    a = np.array([0.0, 0.0, 0.0])
    b = np.array([1.0, 0.0, 0.0])
    c = np.array([0.0, 1.0, 0.0])
    # above the face
    assert abs(point_tri_distance(np.array([0.2, 0.2, 0.5]), a, b, c)
               - 0.5) < 1e-12
    # nearest vertex
    assert abs(point_tri_distance(np.array([-1.0, -1.0, 0.0]), a, b, c)
               - np.sqrt(2)) < 1e-12
    # nearest edge ab
    assert abs(point_tri_distance(np.array([0.5, -2.0, 0.0]), a, b, c)
               - 2.0) < 1e-12
    # batch broadcasting
    p = np.random.default_rng(0).normal(size=(100, 3))
    d = point_tri_distance(p, a[None], b[None], c[None])
    assert d.shape == (100,)


def test_sphere_sdf():
    mef = make_sphere_mef(28, r=0.3)
    tri = mef.positions()[mef.elements]
    n = 40
    dx = np.array([2.0 / n] * 3)
    origin = np.array([-1.0, -1.0, -1.0])
    dmax = 0.4
    phi, _ = unsigned_distance_grid(tri, origin, dx, (n, n, n), dmax)
    sgn = parity_sign(tri, origin, dx, (n, n, n))
    cs = origin[0] + (np.arange(n) + 0.5) * dx[0]
    X, Y, Z = np.meshgrid(cs, cs, cs, indexing="ij")
    r = np.sqrt(X**2 + Y**2 + Z**2)
    want = np.clip(np.abs(r - 0.3), 0, dmax)
    sel = want < dmax - 2 * dx[0]
    # unsigned distance accurate to ~h (faceted sphere + grid resolution)
    err = np.abs(phi - want)[sel]
    assert err.max() < 1.2 * dx[0]
    # sign: inside negative
    inside = r < 0.3 - dx[0]
    outside = (r > 0.3 + dx[0]) & sel
    assert (sgn[inside] == -1).all()
    assert (sgn[outside] == 1).all()


def test_build_distance_cli(tmp_path, monkeypatch):
    from peleanalysis_tpu.cli import main
    from peleanalysis_tpu.io.plotfile import PlotfileReader
    from peleanalysis_tpu.testing import write_synthetic_plotfile
    monkeypatch.chdir(tmp_path)
    plt = str(tmp_path / "plt")
    write_synthetic_plotfile(plt, n_cell=16, n_levels=2)
    assert main(["isosurface", f"infile={plt}", "isoCompName=progress",
                 "isoVal=0.5", "outfile_base=surf"]) == 0
    assert main(["buildDistance", f"infile={plt}", "isoFile=surf.mef",
                 "signComp=progress", "isoVal=0.5",
                 "outfile=dist"]) == 0
    r = PlotfileReader("dist")
    assert r.var_names == ["distance"]
    # distance is negative where progress < 0.5 (outside the hot ball)
    d0 = r.read_level(0)
    vals = np.concatenate([f.ravel() for f in d0])
    assert vals.min() < 0 < vals.max()


def test_band_seed_device_matches_host(tmp_path):
    """The device band kernel (band_seed_device) must reproduce the host
    seeding: exact distances near the surface; sweeps fix the far field."""
    import numpy as np
    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.amr.hierarchy import AmrState
    from peleanalysis_tpu.geom.marching_cubes import extract_isosurface
    from peleanalysis_tpu.geom.sdf import unsigned_distance_grid
    from peleanalysis_tpu.testing import write_synthetic_plotfile

    path = str(tmp_path / "plt")
    write_synthetic_plotfile(path, n_cell=24, n_levels=1)
    ds = DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float64))
    mef = extract_isosurface(ds, "progress", 0.5)
    tri = mef.positions()[mef.elements]
    geom = ds.meta.geoms[0]
    dx = np.array(geom.dx)
    dmax = 4 * dx[0]
    shape = tuple(ds.lmeta[0].bbox.shape)
    phi_d, _ = unsigned_distance_grid(tri, geom.prob_lo, dx, shape, dmax,
                                      engine="device")
    phi_h, _ = unsigned_distance_grid(tri, geom.prob_lo, dx, shape, dmax,
                                      engine="host")
    # analytic: |phi| ~ |r - r_iso| within the unclamped region
    r_iso = 0.15 * np.sqrt(np.log(2.0))
    x = (np.arange(24) + 0.5) / 24
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    r = np.sqrt((X - .5) ** 2 + (Y - .5) ** 2 + (Z - .5) ** 2)
    expect = np.minimum(np.abs(r - r_iso), dmax)
    sel = expect < dmax - dx[0]
    assert np.abs(phi_d[sel] - expect[sel]).max() < 1.5 * dx[0]
    # exact agreement (to f32) in the exact band; beyond it both engines are
    # sweep approximations whose values depend on seeding order — allow the
    # sweep-path tolerance there (the reference has the same property)
    near = expect < 1.0 * dx[0]
    np.testing.assert_allclose(phi_d[near], phi_h[near], atol=5e-6)
    np.testing.assert_allclose(phi_d, phi_h, atol=0.02 * dmax)


def test_isosurface_inrun_distance(tmp_path, monkeypatch):
    """isosurface build_distance_function=1 writes the signed-distance
    plotfile in the same invocation (isosurface.cpp:1595-1654,1732-1748),
    sign from field<isoVal (:1644)."""
    import numpy as np
    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.amr.hierarchy import AmrState
    from peleanalysis_tpu.cli import main
    from peleanalysis_tpu.testing import write_synthetic_plotfile

    path = str(tmp_path / "plt")
    write_synthetic_plotfile(path, n_cell=16, n_levels=2)
    monkeypatch.chdir(tmp_path)
    rc = main(["isosurface", f"infile={path}", "isoCompName=progress",
               "isoVal=0.5", "outfile_base=surf",
               "build_distance_function=1", "dmax=0.1"])
    assert rc == 0
    ds = DenseAmrState.from_batched(
        AmrState.from_plotfile(path + "_dist", dtype=np.float64))
    assert ds.names == ["distance"]
    r_iso = 0.15 * np.sqrt(np.log(2.0))
    for lev in range(2):
        phi = np.asarray(ds.data[lev][0])
        m = np.asarray(ds.valid_mask(lev))
        assert np.abs(phi[m]).max() <= 0.1 + 1e-12
        # sign: negative inside (progress > isoVal near center)
        bbox = ds.lmeta[lev].bbox
        geom = ds.meta.geoms[lev]
        cs = [geom.prob_lo[d] + (np.arange(bbox.lo[d], bbox.hi[d] + 1)
                                 - geom.domain.lo[d] + 0.5) * geom.dx[d]
              for d in range(3)]
        X, Y, Z = np.meshgrid(*cs, indexing="ij")
        r = np.sqrt((X - .5) ** 2 + (Y - .5) ** 2 + (Z - .5) ** 2)
        # reference sign convention (isosurface.cpp:1644): NEGATIVE where
        # field < isoVal.  progress decays with r, so r > r_iso -> negative.
        inside = (r < r_iso - geom.dx[0]) & m
        outside = (r > r_iso + geom.dx[0]) & m
        if inside.any():
            assert (phi[inside] > 0).all()
        assert (phi[outside] < 0).all()
        # magnitude parity with |r - r_iso| in the unclamped band
        sel = m & (np.abs(r - r_iso) < 0.1 - geom.dx[0])
        if sel.any():
            assert np.abs(np.abs(phi[sel])
                          - np.abs(r - r_iso)[sel]).max() < 1.5 * geom.dx[0]


def test_sweeps_propagate_across_whole_grid():
    # r5 review fix (reproduced): the old fixed-count Jacobi shifts only
    # propagated ids ~30 cells, leaving distant cells at dmax.  One small
    # triangle, 64^3 grid, dmax larger than the domain: EVERY cell must
    # carry its true (exact) distance.
    from peleanalysis_tpu.geom.sdf import (point_tri_distance,
                                           unsigned_distance_grid)
    tri = np.array([[[0.49, 0.49, 0.50], [0.51, 0.49, 0.50],
                     [0.50, 0.52, 0.50]]])
    n = 64
    dx = (1.0 / n,) * 3
    phi, _ = unsigned_distance_grid(tri, (0.0, 0.0, 0.0), dx,
                                    (n, n, n), dmax=2.0, engine="host")
    cs = (np.arange(n) + 0.5) / n
    X, Y, Z = np.meshgrid(cs, cs, cs, indexing="ij")
    P = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    want = point_tri_distance(P, np.broadcast_to(tri[0, 0], P.shape),
                              np.broadcast_to(tri[0, 1], P.shape),
                              np.broadcast_to(tri[0, 2], P.shape))
    assert (phi < 2.0).all(), f"{(phi >= 2.0).mean():.0%} cells stuck at dmax"
    np.testing.assert_allclose(phi.reshape(-1), want, atol=1e-9)


def test_parity_sign_diagonal_edges_not_double_counted():
    # r5 review fix (reproduced): rays exactly through an edge shared by
    # two triangles double-counted and sign-flipped whole x-rows.  A cube
    # whose quad faces are split along diagonals, sampled on a grid whose
    # rows hit those diagonals: interior must be -1.
    from peleanalysis_tpu.geom.sdf import parity_sign
    lo, hi = 0.25, 0.75
    quads = []
    for axis in range(3):
        for side in (lo, hi):
            c = [[lo, lo], [hi, lo], [hi, hi], [lo, hi]]
            pts = []
            for u, v in c:
                p = [0.0, 0.0, 0.0]
                p[axis] = side
                p[(axis + 1) % 3] = u
                p[(axis + 2) % 3] = v
                pts.append(p)
            quads.append(pts)
    tris = []
    for q in quads:
        tris.append([q[0], q[1], q[2]])
        tris.append([q[0], q[2], q[3]])
    tris = np.asarray(tris)
    n = 8   # cell centers at (k+0.5)/8 = 0.0625..., row y==z hits diagonals
    sgn = parity_sign(tris, (0.0, 0.0, 0.0), (1.0 / n,) * 3, (n, n, n))
    cs = (np.arange(n) + 0.5) / n
    inside = ((cs[:, None, None] > lo) & (cs[:, None, None] < hi)
              & (cs[None, :, None] > lo) & (cs[None, :, None] < hi)
              & (cs[None, None, :] > lo) & (cs[None, None, :] < hi))
    assert (sgn[inside] == -1).all()
    assert (sgn[~inside] == 1).all()
