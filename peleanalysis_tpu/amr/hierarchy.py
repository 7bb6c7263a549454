"""Device-resident batched AMR hierarchy — the MultiFab stack in JAX.

Each level's boxes are padded to a common shape and stacked into one device
array ``[nbox, ncomp, PX, PY(, PZ)]`` (the "batched FAB" of BASELINE.json).
Irregular box sizes become validity masks; covered-by-finer cells become
covered masks — so every downstream kernel is a dense, statically-shaped map
over the batch, which is exactly what XLA tiles well.

Replaces the reference's MultiFab + AmrData/PlotFileData in-memory model
(/root/reference/Src/grad.cpp:151-169).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from .box import Box, BoxArray
from .geometry import Geometry
from ..io.plotfile import PlotfileReader, write_plotfile


@dataclasses.dataclass
class AmrMeta:
    """Static (host-side) description of the hierarchy."""

    geoms: List[Geometry]
    bas: List[BoxArray]
    ref_ratio: List[int]
    time: float = 0.0
    level_steps: Optional[List[int]] = None
    # True when the source plotfile was DIM=2 (promoted in memory to nz=1;
    # to_plotfile demotes back)
    ndim2: bool = False

    @property
    def n_levels(self) -> int:
        return len(self.bas)

    @property
    def ndim(self) -> int:
        return self.geoms[0].ndim

    def pad_shape(self, lev: int) -> Tuple[int, ...]:
        return self.bas[lev].max_shape


class AmrState:
    """Batched per-level data + masks on device.

    data[lev]:   [nbox, ncomp, *pad_shape]  (no ghost frame; fills produce
                 separately-shaped grown arrays)
    in_box[lev]: [nbox, *pad_shape] bool — cell inside its (possibly smaller
                 than pad) box
    covered[lev]:[nbox, *pad_shape] bool — cell covered by a finer level
                 (jpdf.cpp:373-387 / conditionalMean.cpp:246-258 semantics)
    """

    def __init__(self, meta: AmrMeta, names: Sequence[str],
                 data: List[jnp.ndarray]):
        self.meta = meta
        self.names = list(names)
        self.data = data
        self._in_box: List[Optional[jnp.ndarray]] = [None] * meta.n_levels
        self._covered: List[Optional[jnp.ndarray]] = [None] * meta.n_levels

    # -- construction --------------------------------------------------------
    @classmethod
    def from_plotfile(cls, path: str, names: Optional[Sequence[str]] = None,
                      max_level: Optional[int] = None,
                      is_periodic: Optional[Sequence[bool]] = None,
                      dtype=None) -> "AmrState":
        dtype = dtype or config.compute_dtype
        r = PlotfileReader(path)
        m = r.meta
        finest = m.finest_level if max_level is None else min(max_level,
                                                              m.finest_level)
        names = list(names) if names is not None else list(m.var_names)
        comps = [r.var_index(n) for n in names]
        bas = [r.box_array(lev) for lev in range(finest + 1)]
        fabs = [r.read_level(lev, comps) for lev in range(finest + 1)]
        if m.ndim == 2:
            # promote DIM=2 plotfiles to the 3-D engines with nz=1
            from ..io.plotfile import promote_2d
            geoms, bas, fabs = promote_2d(m, bas, fabs)
            if is_periodic is not None:
                geoms = [Geometry(g.domain, g.prob_lo, g.prob_hi,
                                  tuple(bool(p) for p in is_periodic[:2])
                                  + (False,), g.coord_sys) for g in geoms]
        else:
            geoms = [m.geometry(lev, is_periodic)
                     for lev in range(finest + 1)]
        meta = AmrMeta(geoms, bas, m.ref_ratio[:finest], m.time,
                       m.level_steps, ndim2=(m.ndim == 2))
        data = [_batch_fabs(fabs[lev], bas[lev], dtype)
                for lev in range(finest + 1)]
        return cls(meta, names, data)

    @classmethod
    def from_arrays(cls, meta: AmrMeta, names: Sequence[str],
                    level_fabs: Sequence[Sequence[np.ndarray]],
                    dtype=None) -> "AmrState":
        dtype = dtype or config.compute_dtype
        data = [_batch_fabs(level_fabs[lev], meta.bas[lev], dtype)
                for lev in range(meta.n_levels)]
        return cls(meta, names, data)

    # -- masks ----------------------------------------------------------------
    def in_box_mask(self, lev: int) -> jnp.ndarray:
        if self._in_box[lev] is None:
            self._in_box[lev] = jnp.asarray(
                _in_box_mask_np(self.meta.bas[lev], self.meta.pad_shape(lev)))
        return self._in_box[lev]

    def covered_mask(self, lev: int) -> jnp.ndarray:
        if self._covered[lev] is None:
            self._covered[lev] = jnp.asarray(self._covered_np(lev))
        return self._covered[lev]

    def _covered_np(self, lev: int) -> np.ndarray:
        meta = self.meta
        ba = meta.bas[lev]
        P = meta.pad_shape(lev)
        nbox = len(ba)
        out = np.zeros((nbox,) + P, dtype=bool)
        if lev + 1 >= meta.n_levels:
            return out
        r = meta.ref_ratio[lev]
        fine_coarsened = meta.bas[lev + 1].coarsen(r)
        per = meta.geoms[lev].is_periodic
        dom = meta.geoms[lev].domain
        shifts = _periodic_shifts(per, dom)
        for i, b in enumerate(ba):
            for fb in fine_coarsened:
                for sh in shifts:
                    isect = b.intersect(fb.shift(sh))
                    if not isect.is_empty():
                        sl = tuple(
                            slice(isect.lo[d] - b.lo[d],
                                  isect.hi[d] - b.lo[d] + 1)
                            for d in range(meta.ndim))
                        out[(i,) + sl] = True
        return out

    def valid_mask(self, lev: int) -> jnp.ndarray:
        """Cells that contribute to composite (flattened-AMR) quantities."""
        return self.in_box_mask(lev) & ~self.covered_mask(lev)

    # -- access ---------------------------------------------------------------
    def comp(self, name: str) -> int:
        return self.names.index(name)

    def level_comp(self, lev: int, name: str) -> jnp.ndarray:
        return self.data[lev][:, self.comp(name)]

    def with_data(self, names: Sequence[str],
                  data: List[jnp.ndarray]) -> "AmrState":
        st = AmrState(self.meta, names, data)
        st._in_box = self._in_box
        st._covered = self._covered
        return st

    # -- output ---------------------------------------------------------------
    def to_plotfile(self, path: str, names: Optional[Sequence[str]] = None,
                    dtype=np.float64) -> None:
        names = list(names) if names is not None else self.names
        meta = self.meta
        if jax.default_backend() != "cpu" or _FORCE_PACKED_FETCH:
            # ONE flat fetch of the true box windows instead of one
            # fetch per level of the padded [nbox, nc, px, py, pz] arrays
            level_fabs = _fetch_fabs_packed(self.data, meta.bas)
        else:
            level_fabs = []
            for lev in range(meta.n_levels):
                arr = np.asarray(jax.device_get(self.data[lev]),
                                 dtype=np.float64)
                level_fabs.append(_unbatch_fabs(arr, meta.bas[lev]))
        write_level_fabs(meta, names, level_fabs, path, dtype)

    def to_plotfile_async(self, path: str, submit,
                          names: Optional[Sequence[str]] = None,
                          dtype=np.float64) -> None:
        """Write-back variant (Session.async_writes): dispatch the packed
        layout + start the host copy now, queue the blocking fetch + FAB
        write on the session's write-back thread."""
        names = list(names) if names is not None else self.names
        meta = self.meta
        flat_dev, decode = _fetch_fabs_packed(self.data, meta.bas,
                                              defer=True)
        try:
            flat_dev.copy_to_host_async()
        except Exception:
            pass
        submit(lambda: write_level_fabs(meta, names, decode(), path, dtype))


def write_level_fabs(meta, names, level_fabs, path: str, dtype=np.float64):
    """Write per-level fab lists as a plotfile (shared tail of the batched
    and dense writers; handles the DIM=2 demotion)."""
    geoms, bas = meta.geoms, meta.bas
    if meta.ndim2:  # demote back to a DIM=2 plotfile
        geoms = [Geometry(Box(g.domain.lo[:2], g.domain.hi[:2]),
                          g.prob_lo[:2], g.prob_hi[:2],
                          g.is_periodic[:2], g.coord_sys) for g in geoms]
        bas = [BoxArray([Box(b.lo[:2], b.hi[:2]) for b in ba])
               for ba in meta.bas]
        level_fabs = [[f[..., 0] for f in fabs] for fabs in level_fabs]
    write_plotfile(path, names, meta.time, geoms, meta.ref_ratio,
                   bas, level_fabs,
                   level_steps=meta.level_steps, dtype=dtype)


_FORCE_PACKED_FETCH = bool(int(
    __import__("os").environ.get("PELE_PACKED_FETCH", "0")))
_PACK_FNS: dict = {}


def unflatten_level_fabs(flat: np.ndarray, ncs, bas) -> list:
    """Walk a packed flat fetch back into per-level [nc, *box.shape] f64
    fab lists (the decode half of the box-window pack jits — shared by the
    batched and dense writers so the layout lives in ONE place)."""
    level_fabs, p = [], 0
    for nc, ba in zip(ncs, bas):
        fabs = []
        for b in ba:
            n = nc * int(np.prod(b.shape))
            fabs.append(flat[p: p + n].astype(np.float64, copy=False)
                        .reshape((nc,) + b.shape))
            p += n
        level_fabs.append(fabs)
    return level_fabs


def _fetch_fabs_packed(data: Sequence[jnp.ndarray],
                       bas: Sequence[BoxArray], defer: bool = False):
    """Fetch every level's true box windows in ONE flat device->host
    transfer; returns per-level fab lists (f64, the writer's dtype).
    defer=True returns (device_vector, decode_thunk) instead — the
    write-back path starts the copy asynchronously and decodes later."""
    key = tuple((tuple(d.shape), str(d.dtype),
                 tuple(tuple(b.shape) for b in ba))
                for d, ba in zip(data, bas))
    fn = _PACK_FNS.get(key)
    if fn is None:
        def pack(levels):
            parts = []
            for d, ba in zip(levels, bas):
                for i, b in enumerate(ba):
                    parts.append(d[(i, slice(None))
                                   + tuple(slice(0, s) for s in b.shape)]
                                 .ravel())
            return jnp.concatenate(parts)
        fn = _PACK_FNS[key] = jax.jit(pack)
        if len(_PACK_FNS) > 64:
            _PACK_FNS.pop(next(iter(_PACK_FNS)))
    flat_dev = fn(list(data))
    ncs = [d.shape[1] for d in data]

    def decode(dev=flat_dev):
        return unflatten_level_fabs(np.asarray(dev), ncs, bas)

    if defer:
        return flat_dev, decode
    return decode()


def _batch_fabs(fabs: Sequence[np.ndarray], ba: BoxArray, dtype) -> jnp.ndarray:
    P = ba.max_shape
    ncomp = fabs[0].shape[0]
    out = np.zeros((len(ba), ncomp) + P, dtype=np.dtype(dtype).name)
    for i, f in enumerate(fabs):
        sl = (i, slice(None)) + tuple(slice(0, s) for s in f.shape[1:])
        out[sl] = f
    return jnp.asarray(out)


def _unbatch_fabs(arr: np.ndarray, ba: BoxArray) -> List[np.ndarray]:
    out = []
    for i, b in enumerate(ba):
        sl = (i, slice(None)) + tuple(slice(0, s) for s in b.shape)
        out.append(np.ascontiguousarray(arr[sl]))
    return out


def _in_box_mask_np(ba: BoxArray, P: Tuple[int, ...]) -> np.ndarray:
    nbox = len(ba)
    ndim = ba.ndim
    m = np.ones((nbox,) + tuple(P), dtype=bool)
    for d in range(ndim):
        idx = np.arange(P[d])
        shape = (nbox,) + tuple(P[k] if k == d else 1 for k in range(ndim))
        ok = idx[None, :] < ba.sizes[:, d : d + 1]
        m &= ok.reshape(shape)
    return m


def _periodic_shifts(per: Sequence[bool], dom: Box):
    import itertools

    opts = [([-n, 0, n] if p else [0])
            for p, n in zip(per, dom.shape)]
    return [s for s in itertools.product(*opts)]
