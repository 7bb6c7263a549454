"""Multi-chip particle migration (parallel/particles.py) vs the resident
single-device march — the Redistribute parity check
(/root/reference/Src/StreamPC.cpp:86-141)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peleanalysis_tpu.parallel.particles import (
    migrate_march, trace_streamlines_migrating)
from peleanalysis_tpu.stream.trace import _trace_level, trace_streamlines


def _vortex_field(shape, plo, dx):
    """Swirling velocity with x drift so particles cross slab boundaries."""
    x = plo[0] + (np.arange(shape[0]) + 0.5) * dx[0]
    y = plo[1] + (np.arange(shape[1]) + 0.5) * dx[1]
    z = plo[2] + (np.arange(shape[2]) + 0.5) * dx[2]
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    u = 1.0 + 0.3 * np.sin(2 * np.pi * Y)
    v = 0.5 * np.cos(2 * np.pi * X) + 0.2
    w = 0.3 * np.sin(2 * np.pi * (X + Y))
    return np.stack([u, v, w])


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:8]), ("parts",))


def test_migrate_matches_resident(mesh8):
    shape = (96, 24, 24)
    plo = np.zeros(3)
    dx = np.array([1.0 / 96, 1.0 / 24, 1.0 / 24])
    vec = _vortex_field(shape, plo, dx).astype(np.float64)
    h = 0.9 * dx[0]
    n_steps = 40

    rng = np.random.default_rng(0)
    seeds = np.stack([rng.uniform(0.15, 0.85, 60),
                      rng.uniform(0.2, 0.8, 60),
                      rng.uniform(0.2, 0.8, 60)], axis=1)
    dirs = np.where(np.arange(60) % 2 == 0, 1.0, -1.0)

    # resident reference: one global array, same ntrpv math
    pos_ref, _ = _trace_level(jnp.asarray(vec), jnp.zeros((0,) + shape),
                              jnp.asarray(plo), jnp.asarray(dx), h,
                              jnp.asarray(seeds), n_steps, dirs[:, None])
    pos_ref = np.transpose(np.asarray(pos_ref), (1, 0, 2))

    paths, counts = migrate_march(vec, plo, dx, h, seeds, n_steps, dirs,
                                  mesh8)
    # the drifting field must actually exercise migration: seeds spread
    # over >1 slab and every particle drifts ~n_steps*h/dx ~ 36 cells
    assert (counts > 0).sum() >= 4
    assert np.allclose(paths, pos_ref, atol=1e-12), (
        np.abs(paths - pos_ref).max())


def test_migrate_overflow_detected(mesh8):
    shape = (96, 8, 8)
    plo = np.zeros(3)
    dx = np.array([1.0 / 96, 1.0 / 8, 1.0 / 8])
    vec = np.zeros((3,) + shape)
    vec[0] = 1.0  # uniform +x drift: every particle migrates together
    seeds = np.stack([np.full(32, 0.124), np.full(32, 0.5),
                      np.full(32, 0.5)], axis=1)
    with pytest.raises(RuntimeError, match="overflow"):
        migrate_march(vec, plo, dx, 0.9 * dx[0], seeds, 30,
                      np.ones(32), mesh8, capacity=33, send_capacity=4)


def test_trace_streamlines_migrating_matches(mesh8, tmp_path):
    from peleanalysis_tpu.amr.dense import DenseAmrState
    from peleanalysis_tpu.amr.hierarchy import AmrState
    from peleanalysis_tpu.testing import write_synthetic_plotfile

    path = str(tmp_path / "plt00000")
    fields = {
        "x_velocity": lambda x, y, z: 1.0 + 0.3 * np.sin(2 * np.pi * y),
        "y_velocity": lambda x, y, z: 0.5 * np.cos(2 * np.pi * x) + 0.2,
        "z_velocity": lambda x, y, z: 0.3 * np.sin(2 * np.pi * (x + y)),
        "temp": lambda x, y, z: 300 + 1500 * np.exp(
            -((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) / 0.05),
    }
    write_synthetic_plotfile(path, n_cell=32, n_levels=2, fields=fields)
    ds = DenseAmrState.from_batched(
        AmrState.from_plotfile(path, dtype=np.float64))
    rng = np.random.default_rng(1)
    seeds = np.stack([rng.uniform(0.2, 0.8, 24) for _ in range(3)], axis=1)
    ref = trace_streamlines(ds, seeds, 21, 0.5, sample_names=("temp",))
    got = trace_streamlines_migrating(ds, seeds, 21, 0.5, mesh8,
                                      sample_names=("temp",))
    assert got.shape == ref.shape
    assert np.allclose(got, ref, atol=1e-10), np.abs(got - ref).max()


def test_part_stream_cli_ndevices(mesh8, tmp_path, monkeypatch):
    """partStream ndevices=8 through the real CLI matches ndevices=1."""
    from peleanalysis_tpu.cli import main as cli
    from peleanalysis_tpu.testing import write_synthetic_plotfile

    monkeypatch.chdir(tmp_path)
    fields = {
        "x_velocity": lambda x, y, z: 1.0 + 0.3 * np.sin(2 * np.pi * y),
        "y_velocity": lambda x, y, z: 0.5 * np.cos(2 * np.pi * x) + 0.2,
        "z_velocity": lambda x, y, z: 0.3 * np.sin(2 * np.pi * (x + y)),
    }
    write_synthetic_plotfile("plt", n_cell=32, n_levels=2, fields=fields)
    base = ["partStream", "infile=plt", "seedRakeL=0.3 0.4 0.45",
            "seedRakeR=0.7 0.6 0.55", "seedRakeNum=16", "Nsteps=21",
            "hRK=0.5"]
    assert cli(base + ["outFile=res.dat"]) == 0
    assert cli(base + ["ndevices=8", "outFile=mig.dat"]) == 0

    def load(p):
        rows = []
        for ln in open(p):
            toks = ln.split()
            try:
                rows.append([float(v) for v in toks])
            except ValueError:
                pass
        return np.array([r for r in rows if len(r) == 3])

    a, b = load("res.dat"), load("mig.dat")
    assert a.shape == b.shape and a.shape[0] > 0
    np.testing.assert_allclose(a, b, atol=1e-9)


def test_migrate_march_2d_mesh():
    """2-D (4x2) block decomposition with dimension-ordered routing ==
    the resident march (a corner-crossing mover hops x then y inside one
    step)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        import pytest
        pytest.skip("needs 8 virtual devices")
    from peleanalysis_tpu.parallel.particles import migrate_march
    from peleanalysis_tpu.stream.trace import _trace_level

    shape = (64, 32, 8)
    xg = (np.arange(shape[0]) + 0.5) / shape[0]
    yg = (np.arange(shape[1]) + 0.5) / shape[1]
    vec = np.zeros((3,) + shape)
    # diagonal swirl: particles cross x AND y block boundaries
    vec[0] = 1.0
    vec[1] = 0.8 * np.cos(2 * np.pi * xg)[:, None, None] + 0.4
    vec[2] = 0.2 * np.sin(2 * np.pi * yg)[None, :, None]
    plo = np.zeros(3)
    dxm = np.array([1.0 / s for s in shape])
    rng = np.random.default_rng(5)
    seeds = np.stack([rng.uniform(0.15, 0.6, 24),
                      rng.uniform(0.2, 0.8, 24),
                      rng.uniform(0.3, 0.7, 24)], axis=1)
    dirs = np.where(np.arange(24) % 2 == 0, 1.0, -1.0)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("bx", "by"))
    paths, counts = migrate_march(vec, plo, dxm, 0.9 * dxm[0], seeds, 14,
                                  dirs, mesh)
    ref, _ = _trace_level(jnp.asarray(vec), jnp.zeros((0,) + shape),
                          jnp.asarray(plo), jnp.asarray(dxm), 0.9 * dxm[0],
                          jnp.asarray(seeds), 14, dirs[:, None])
    ref = np.transpose(np.asarray(ref), (1, 0, 2))
    assert counts.sum() == 24
    assert np.allclose(paths, ref, atol=1e-6), np.abs(paths - ref).max()
