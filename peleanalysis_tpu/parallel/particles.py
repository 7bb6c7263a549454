"""Multi-device particle migration — the Redistribute analog for partStream.

The reference's StreamPC advances an AMReX ParticleContainer one RK step at
a time and calls Redistribute() after every step so each particle always
lives on the MPI rank owning its current grid patch
(/root/reference/Src/StreamPC.cpp:86-141).  The single-chip engine here
keeps every line resident instead (stream/trace.py) — fine until lines plus
grown fields exceed one device's memory.

This module is the multi-device path, designed for XLA rather than
translated from MPI:

  * the level's grown velocity field is split into X slabs, one per device
    of a 1-D ``jax.sharding.Mesh``; each device's memory holds ONLY its slab
    plus a halo ring wide enough for one RK4 step (the global array is
    staged through host RAM, never through a single device)
  * particles live in fixed-capacity per-device slot buffers (static
    shapes; XLA-friendly): position, ±direction, global id, alive/used
    masks
  * after every RK4 step, movers are compacted to the front of fixed-size
    send buffers (argsort on a boolean — no dynamic shapes) and exchanged
    with ring neighbors by ``lax.ppermute`` inside a ``shard_map`` — the
    Redistribute() analog
  * trajectories are NOT carried by the particles (the reference carries
    Nsteps*SPACEDIM reals per particle, StreamPC.cpp:14-35): each step the
    kernel logs (id, position) snapshots via the ``lax.scan`` outputs, and
    the full [nseed, nsteps+1, 3] path array is reassembled from the log
    afterwards — migration moves 5 words per particle instead of the whole
    history
  * a step displaces a particle by at most h_phys (RK4 of a unit vector),
    so movers only ever cross to an adjacent slab; capacity overruns are
    detected and reported, never silent

Numerics match stream/trace.py's ntrpv math (stream_nd.f90:153-206) with
the same vnrml-normalized RK4 (stream_nd.f90:116-151), so the migrating
march agrees with the resident march to roundoff (tests/test_migrate.py).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

AXIS = "parts"

_CORNERS = np.array([(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                     (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)])


def _owner(sx: jnp.ndarray, core: int, ndev: int) -> jnp.ndarray:
    """Block owner of grid coordinate sx = (x - plo_g)/dx (cell-edge units
    of the grown box): device d owns sx in [d*core, (d+1)*core)."""
    return jnp.clip(jnp.floor(sx / core).astype(jnp.int32), 0, ndev - 1)


def _build_slabs(vec: np.ndarray, cores, halos, nds) -> np.ndarray:
    """[3, SX, SY, SZ] -> [*nds, 3, core_d+2*halo_d per sharded dim, ...]
    edge-padded blocks over a 1-D/2-D/3-D block grid.  Host-side staging:
    each device receives only its block."""
    k = len(nds)
    pads = [(0, 0)]
    for d in range(3):
        if d < k:
            pads.append((halos[d],
                         cores[d] * nds[d] - vec.shape[1 + d] + halos[d]))
        else:
            pads.append((0, 0))
    padded = np.pad(vec, pads, mode="edge")
    grid = list(np.ndindex(*nds))
    blocks = []
    for idx in grid:
        sl = [slice(None)]
        for d in range(3):
            if d < k:
                o = idx[d] * cores[d]
                sl.append(slice(o, o + cores[d] + 2 * halos[d]))
            else:
                sl.append(slice(None))
        blocks.append(padded[tuple(sl)])
    out = np.stack(blocks)
    return out.reshape(tuple(nds) + out.shape[1:])


class _HashableMesh:
    """Static-arg wrapper so the jitted entry can rebuild the Mesh."""

    def __init__(self, devices, axes, shape):
        self.devices = tuple(devices)
        self.axes = tuple(axes)
        self.shape = tuple(shape)

    def build(self) -> Mesh:
        return Mesh(np.array(self.devices).reshape(self.shape), self.axes)

    def __hash__(self):
        return hash((self.devices, self.axes, self.shape))

    def __eq__(self, other):
        return (isinstance(other, _HashableMesh)
                and self.devices == other.devices
                and self.axes == other.axes and self.shape == other.shape)


@partial(jax.jit, static_argnames=("n_steps", "cores", "halos", "cap",
                                   "scap", "mesh_"))
def _migrate_march(slabs, plo_loc, pos0, pdir0, pid0, used0,
                   plo_g, dx, gshape, h,
                   n_steps: int, cores, halos, cap: int,
                   scap: int, mesh_: _HashableMesh):
    """shard_map'd RK4 march with per-step neighbor migration over a
    1-D/2-D/3-D block grid (dimension-ordered routing: after the RK step,
    movers hop along each mesh axis in turn — a corner-crossing particle
    reaches its diagonal neighbor in two in-step hops, the Redistribute()
    analog for a multi-axis DistributionMapping).

    slabs     [*nds, 3, per-dim core+2h, ...]  P(*axes)
    plo_loc   [*nds, 3]                        P(*axes)  block grown-box lo
    pos0      [*nds, cap, 3]; pdir0/pid0/used0 likewise
    plo_g/dx/gshape/h: replicated scalars of the GLOBAL grown box.
    Returns (ids [n_steps, ndev*cap], pos [n_steps, ndev*cap, 3],
             used [n_steps, ndev*cap], overflow [ndev]).
    """
    mesh = mesh_.build()
    axes = mesh_.axes
    nds = mesh_.shape
    k = len(axes)

    def shard_fn(slab, plo_l, pos0, pdir0, pid0, used0, plo_g, dx, gshape,
                 h):
        slab = slab[(0,) * k]          # [3, SLX, SLY, SZ]
        plo_l = plo_l[(0,) * k]
        SLX, SY, SZ = slab.shape[1:]
        lshape = jnp.asarray([SLX, SY, SZ])
        flat = slab.reshape(3, -1)
        corner_off = jnp.asarray(
            [o[0] * SY * SZ + o[1] * SZ + o[2] for o in _CORNERS], jnp.int32)

        def interp_unit(x, direction):
            # local clamped interpolation + GLOBAL validity (same bound as
            # the resident engine: b in [0, gshape-2] of the grown box)
            bg = jnp.floor((x - plo_g) / dx - 0.5)
            ok = jnp.all((bg >= 0) & (bg + 1 <= gshape - 1), axis=-1)
            xc = (x - plo_l) / dx - 0.5
            b = jnp.floor(xc).astype(jnp.int32)
            b = jnp.clip(b, 0, lshape - 2)
            t = jnp.clip(xc - b, 0.0, 1.0)
            base = (b[:, 0] * SY + b[:, 1]) * SZ + b[:, 2]
            idx = base[:, None] + corner_off[None, :]
            c = flat[:, idx]                              # [3, cap, 8]
            tx, ty, tz = t[:, 0:1], t[:, 1:2], t[:, 2:3]
            wx = jnp.concatenate([1 - tx, tx], 1)
            wy = jnp.concatenate([1 - ty, ty], 1)
            wz = jnp.concatenate([1 - tz, tz], 1)
            w = (wx[:, _CORNERS[:, 0]] * wy[:, _CORNERS[:, 1]]
                 * wz[:, _CORNERS[:, 2]])
            v = jnp.einsum("fnc,nc->nf", c, w)
            n = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
            return (direction[:, None] * v
                    / jnp.maximum(n, jnp.finfo(v.dtype).tiny)), ok

        mes = [jax.lax.axis_index(axes[d]) for d in range(k)]

        def pack_send(mask, pos, pdir, pid):
            # movers are alive by construction (moving = alive & ...), so
            # no alive flag ships — arrivals are set alive=True directly
            order = jnp.argsort(~mask)                    # movers first
            sel = order[:scap]
            over = jnp.sum(mask) > scap
            return (pos[sel], pdir[sel], pid[sel], mask[sel]), over

        def route_dim(d, pos, pdir, pid, alive, used, over):
            # movers cross at most one block per step per dim (halo bound)
            nd = nds[d]
            if nd == 1:
                return pos, pdir, pid, alive, used, over
            fwd = [(i, i + 1) for i in range(nd - 1)]
            bwd = [(i + 1, i) for i in range(nd - 1)]
            own = _owner((pos[:, d] - plo_g[d]) / dx[d], cores[d], nd)
            moving = alive & (own != mes[d])
            go_r = moving & (own > mes[d])
            go_l = moving & (own < mes[d])
            send_r, ov_r = pack_send(go_r, pos, pdir, pid)
            send_l, ov_l = pack_send(go_l, pos, pdir, pid)
            gone = go_r | go_l
            used = used & ~gone
            alive = alive & ~gone

            def perm(pack, pairs):
                return tuple(jax.lax.ppermute(a, axes[d], pairs)
                             for a in pack)

            recv_l = perm(send_r, fwd)    # arrives from the left neighbor
            recv_r = perm(send_l, bwd)    # arrives from the right neighbor
            rpos = jnp.concatenate([recv_l[0], recv_r[0]])
            rdir = jnp.concatenate([recv_l[1], recv_r[1]])
            rid = jnp.concatenate([recv_l[2], recv_r[2]])
            rvalid = jnp.concatenate([recv_l[3], recv_r[3]])

            # merge received into free slots (valid arrivals first)
            r_ord = jnp.argsort(~rvalid)
            rpos, rdir, rid = rpos[r_ord], rdir[r_ord], rid[r_ord]
            rvalid = rvalid[r_ord]
            free = jnp.argsort(used)                      # free slots first
            if 2 * scap > cap:  # pad with the drop sentinel
                free = jnp.concatenate(
                    [free, jnp.full(2 * scap - cap, cap, free.dtype)])
            nfree = cap - jnp.sum(used)
            can = rvalid & (jnp.arange(2 * scap) < nfree)
            tgt = jnp.where(can, free[:2 * scap], cap)
            pos = pos.at[tgt].set(rpos, mode="drop")
            pdir = pdir.at[tgt].set(rdir, mode="drop")
            pid = pid.at[tgt].set(rid, mode="drop")
            alive = alive.at[tgt].set(True, mode="drop")
            used = used.at[tgt].set(True, mode="drop")
            over = over | ov_r | ov_l | (jnp.sum(rvalid) > nfree)
            return pos, pdir, pid, alive, used, over

        def step(carry, _):
            pos, pdir, pid, alive, used, over = carry
            k1, ok1 = interp_unit(pos, pdir)
            k2, ok2 = interp_unit(pos + 0.5 * h * k1, pdir)
            k3, ok3 = interp_unit(pos + 0.5 * h * k2, pdir)
            k4, ok4 = interp_unit(pos + h * k3, pdir)
            xn = pos + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            ok = ok1 & ok2 & ok3 & ok4
            alive_n = alive & used & ok
            pos = jnp.where(alive_n[:, None], xn, pos)

            # ---- Redistribute(): dimension-ordered per-axis hops --------
            for d in range(k):
                pos, pdir, pid, alive_n, used, over = route_dim(
                    d, pos, pdir, pid, alive_n, used, over)
            return ((pos, pdir, pid, alive_n, used, over),
                    (pid, pos, used))

        # the overflow flag must be device-varying from the start (scan-vma)
        z = (0,) * k
        over0 = jnp.any(used0[z]) & False
        carry0 = (pos0[z], pdir0[z], pid0[z], used0[z], used0[z], over0)
        (_, _, _, _, _, over), ys = jax.lax.scan(step, carry0, None,
                                                 length=n_steps)
        ids, pos, used = ys
        lead = (slice(None),) + (None,) * k
        return ids[lead], pos[lead], used[lead], over[(None,) * k]

    spec = P(*axes)
    spec_t = P(None, *axes)
    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, spec, P(), P(), P(), P()),
        out_specs=(spec_t, spec_t, spec_t, spec))
    ids, pos, used, over = fn(slabs, plo_loc, pos0, pdir0, pid0, used0,
                              plo_g, dx, gshape, h)
    n = ids.shape[0]
    return (ids.reshape(n, -1), pos.reshape(n, -1, 3),
            used.reshape(n, -1), over)


def migrate_march(vec: np.ndarray, plo_g, dx, h_phys: float,
                  seeds: np.ndarray, n_steps: int, dirs: np.ndarray,
                  mesh: Mesh, capacity: Optional[int] = None,
                  send_capacity: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """March `seeds` (with per-seed ±1 `dirs`) n_steps RK4 steps through the
    grown field `vec` [3, SX, SY, SZ], block-sharded over `mesh` (1-D X
    slabs, or 2-D/3-D blocks when the mesh has more axes) with per-step
    dimension-ordered ppermute migration.  Returns (paths
    [nseed, n_steps+1, 3], initial per-device load).  Raises on send/slot
    capacity overflow."""
    vec = np.asarray(vec)
    dtype = vec.dtype
    nds = tuple(int(n) for n in mesh.devices.shape)
    k = len(nds)
    ndev = int(np.prod(nds))
    dx = np.asarray(dx, dtype=dtype)
    cores, halos = [], []
    for d in range(k):
        core_d = -(-vec.shape[1 + d] // nds[d])
        halo_d = int(np.ceil(h_phys / float(dx[d]))) + 2
        if nds[d] > 1 and core_d <= halo_d:
            raise ValueError(
                f"block core {core_d} cells <= halo {halo_d} along dim {d}:"
                f" fewer devices needed for extent {vec.shape[1 + d]}")
        cores.append(core_d)
        halos.append(halo_d)
    cores, halos = tuple(cores), tuple(halos)
    slabs = _build_slabs(vec, cores, halos, nds)

    seeds = np.asarray(seeds, dtype=dtype)
    nseed = len(seeds)
    own_nd = [np.clip(((seeds[:, d] - plo_g[d]) / dx[d]
                       // cores[d]).astype(np.int64), 0, nds[d] - 1)
              for d in range(k)]
    own = np.ravel_multi_index(own_nd, nds)
    counts = np.bincount(own, minlength=ndev)
    cap = capacity or max(8, int(2 * counts.max()))
    if counts.max() > cap:
        raise ValueError(f"capacity {cap} < max initial load {counts.max()}")
    scap = send_capacity or max(8, cap // 2)

    pos0 = np.zeros((ndev, cap, 3), dtype)
    pdir0 = np.ones((ndev, cap), dtype)
    pid0 = np.full((ndev, cap), -1, np.int32)
    used0 = np.zeros((ndev, cap), bool)
    slot = np.zeros(ndev, np.int64)
    for i in range(nseed):
        d = own[i]
        pos0[d, slot[d]] = seeds[i]
        pdir0[d, slot[d]] = dirs[i]
        pid0[d, slot[d]] = i
        used0[d, slot[d]] = True
        slot[d] += 1

    plo_rows = []
    for idx in np.ndindex(*nds):
        row = [plo_g[d] + ((idx[d] * cores[d] - halos[d]) * dx[d]
                           if d < k else 0.0) for d in range(3)]
        for d in range(k, 3):
            row[d] = plo_g[d]
        plo_rows.append(np.array(row, dtype=dtype))
    plo_loc = np.stack(plo_rows).reshape(nds + (3,))

    axes = tuple(mesh.axis_names)
    sh = NamedSharding(mesh, P(*axes))

    def put(a):
        return jax.device_put(a, sh)

    def bshape(a):
        return a.reshape(nds + a.shape[1:])

    hm = _HashableMesh(mesh.devices.flatten(), axes, nds)
    ids, pos, used, over = _migrate_march(
        put(slabs), put(plo_loc),
        put(bshape(pos0)), put(bshape(pdir0)), put(bshape(pid0)),
        put(bshape(used0)),
        jnp.asarray(np.asarray(plo_g, dtype)), jnp.asarray(dx),
        jnp.asarray(np.asarray(vec.shape[1:], np.int32)),
        jnp.asarray(np.asarray(h_phys, dtype)),
        n_steps, cores, halos, cap, scap, hm)
    if bool(np.asarray(over).any()):
        raise RuntimeError(
            "particle migration overflow: raise capacity=/send_capacity=")
    ids = np.asarray(ids)
    pos = np.asarray(pos)
    used = np.asarray(used) & (ids >= 0)

    out = np.zeros((nseed, n_steps + 1, 3), dtype)
    out[:, 0] = seeds
    for s in range(n_steps):
        v = used[s]
        out[ids[s, v], s + 1] = pos[s, v]
    return out, counts


def trace_streamlines_migrating(
        dstate, seeds: np.ndarray, n_rk_steps: int, h_rk: float,
        mesh: Mesh, sample_names: Sequence[str] = (), bc=None,
        capacity: Optional[int] = None) -> np.ndarray:
    """Multi-chip partStream: per-level grown fields staged to X slabs, the
    ± march run as one doubled-seed migrating cloud, paths reassembled in
    seed order.  Same output layout as stream.trace.trace_streamlines
    ([nseed, 2*nRKh+1, 3+nf], j=nRKh at the seed)."""
    from ..ops.dense_fill import fill_dense_arrays
    from ..stream.trace import (_sample_fields, assign_seeds_to_levels,
                                push_nodes_inside)

    meta = dstate.meta
    n_half = (n_rk_steps - 1) // 2
    fin = meta.n_levels - 1
    h_phys = h_rk * meta.geoms[fin].dx[0]
    seeds = push_nodes_inside(np.asarray(seeds, np.float64), meta.geoms[0])
    owner = assign_seeds_to_levels(dstate, seeds)

    vec_names = ["x_velocity", "y_velocity", "z_velocity"]
    if "z_velocity" not in dstate.names:
        raise ValueError("the migrating march is 3-D only (2-D plotfiles "
                         "fit one chip; use the resident engine)")
    comps = [dstate.comp(n) for n in vec_names]
    scomps = [dstate.comp(n) for n in sample_names]
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]
    all_data = [d[np.asarray(comps + scomps)] for d in dstate.data]
    nf = len(sample_names)

    out = np.zeros((len(seeds), 2 * n_half + 1, 3 + nf))
    for lev in range(meta.n_levels):
        sel = np.nonzero(owner == lev)[0]
        if len(sel) == 0:
            continue
        geom = meta.geoms[lev]
        dx = np.array(geom.dx)
        ngrow = int(np.ceil(h_phys * n_half / dx.min())) + 2
        gbox = dstate.lmeta[lev].bbox.grow(ngrow)
        plo_g = (np.array(geom.prob_lo)
                 + (np.array(gbox.lo) - np.array(geom.domain.lo)) * dx)
        grown = np.asarray(fill_dense_arrays(
            meta, dstate.lmeta, all_data, masks, lev, ngrow, bc, "linear"))
        ns = len(sel)
        seeds2 = np.concatenate([seeds[sel], seeds[sel]])
        dirs = np.concatenate([np.ones(ns), -np.ones(ns)])
        pos2, _ = migrate_march(grown[:3], plo_g, dx, h_phys, seeds2,
                                n_half, dirs, mesh, capacity=capacity)
        path = np.concatenate(
            [pos2[ns:, ::-1][:, :-1], pos2[:ns]], axis=1)
        if nf:
            vals = np.asarray(_sample_fields(
                jnp.asarray(grown[3:]), jnp.asarray(plo_g), jnp.asarray(dx),
                jnp.asarray(path)))
            path = np.concatenate([path, vals], axis=-1)
        out[sel] = path
    return out
