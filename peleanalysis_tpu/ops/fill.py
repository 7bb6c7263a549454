"""Ghost-fill engine: the JAX FillPatch.

Replaces the reference's ``FillBoundary`` / ``FillPatchSingleLevel`` /
``FillPatchTwoLevels`` / ``PCInterp`` stack (usage at
/root/reference/Src/isosurface.cpp:1509-1527, Src/grad.cpp:169,
Src/stream.cpp:839-874).

Design: all irregular index arithmetic happens **once on host** (numpy) and is
baked into per-(BoxArray, ngrow, BC) gather plans; the device-side fill is then
a single fused gather — `vals = data_flat[src]` — which XLA streams straight
from device memory with no data-dependent control flow.  Same-level halo exchange,
periodic wrap, physical BCs (first-order extrap / reflect even / reflect odd),
and coarse-fine interpolation all collapse into that one gather (+ a select
against the coarse gather and a sign multiply).

Coarse-fine interpolation modes:
  * "pc"     — piecewise constant (AMReX PCInterp; isosurface.cpp:1474-1527)
  * "linear" — tri/bi-linear from coarse cell centers (AMReX CellBilinear;
               stream.cpp:860-874), implemented as 2**D weighted gathers.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..amr.box import BoxArray
from ..amr.geometry import Geometry

# Physical BC modes (per dim per side); reference grad.cpp:136-144 builds
# Periodic / Neumann (-> foextrap ghost) / reflect_odd from is_per / sym_dir.
FOEXTRAP = "foextrap"
REFLECT_EVEN = "reflect_even"
REFLECT_ODD = "reflect_odd"

BCSpec = Tuple[Tuple[str, str], ...]  # ((lo_mode, hi_mode) per dim)


def default_bc(ndim: int) -> BCSpec:
    return tuple((FOEXTRAP, FOEXTRAP) for _ in range(ndim))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FillPlan:
    """Precomputed gather plan for one (level, ngrow, BC) combination."""

    same_src: jnp.ndarray          # int32 [nbox, *grown_shape] flat idx into fine
    sign: Optional[jnp.ndarray]    # int8, or None when no reflect_odd in BC
    use_crse: Optional[jnp.ndarray]      # bool, None for single-level fill
    crse_src: Optional[jnp.ndarray]      # int32 [..., 2**D] (linear) or [...] (pc)
    crse_wt: Optional[jnp.ndarray]       # float [..., 2**D] for linear, else None
    ngrow: int
    grown_shape: Tuple[int, ...]
    fine_flat_len: int
    crse_flat_len: int

    def tree_flatten(self):
        leaves = (self.same_src, self.sign, self.use_crse, self.crse_src,
                  self.crse_wt)
        aux = (self.ngrow, self.grown_shape, self.fine_flat_len,
               self.crse_flat_len)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)


def _owner_array(ba: BoxArray, domain_lo, domain_shape) -> np.ndarray:
    own = np.full(tuple(domain_shape), -1, dtype=np.int32)
    for i, b in enumerate(ba):
        sl = tuple(
            slice(b.lo[d] - domain_lo[d], b.hi[d] - domain_lo[d] + 1)
            for d in range(ba.ndim)
        )
        own[sl] = i
    return own


def _map_ghosts_1d(g_idx: np.ndarray, dlo: int, dhi: int, periodic: bool,
                   bc_lo: str, bc_hi: str):
    """Map raw global indices along one dim to in-domain indices + odd-sign."""
    idx = g_idx.copy()
    sign = np.ones_like(idx, dtype=np.int8)
    n = dhi - dlo + 1
    if periodic:
        idx = (idx - dlo) % n + dlo
        return idx, sign
    below = idx < dlo
    above = idx > dhi
    for mask, bc, edge in ((below, bc_lo, dlo), (above, bc_hi, dhi)):
        if not mask.any():
            continue
        if bc == FOEXTRAP:
            idx[mask] = edge
        elif bc in (REFLECT_EVEN, REFLECT_ODD):
            # ghost at dlo-k mirrors interior dlo+k-1; dhi+k mirrors dhi-k+1
            refl = 2 * edge - idx[mask] + (-1 if edge == dlo else 1)
            idx[mask] = np.clip(refl, dlo, dhi)
            if bc == REFLECT_ODD:
                sign[mask] = -1
        else:
            raise ValueError(f"unknown BC mode {bc}")
    return idx, sign


def build_fill_plan(
    ba: BoxArray,
    geom: Geometry,
    ngrow: int,
    pad_shape: Tuple[int, ...],
    ba_crse: Optional[BoxArray] = None,
    pad_shape_crse: Optional[Tuple[int, ...]] = None,
    ratio: int = 2,
    bc: Optional[BCSpec] = None,
    interp: str = "pc",
) -> FillPlan:
    ndim = ba.ndim
    if bc is None:
        bc = default_bc(ndim)
    dom = geom.domain
    dlo = np.array(dom.lo)
    dshape = np.array(dom.shape)
    nbox = len(ba)
    P = tuple(pad_shape)
    S = tuple(p + 2 * ngrow for p in P)

    # global coords of every cell of every padded grown box, one dim at a time
    per_dim_idx = []
    per_dim_sign = []
    for d in range(ndim):
        raw = ba.lo[:, d : d + 1] - ngrow + np.arange(S[d])[None, :]  # [nbox,Sd]
        idx, sgn = _map_ghosts_1d(raw, dom.lo[d], dom.hi[d],
                                  geom.is_periodic[d], bc[d][0], bc[d][1])
        per_dim_idx.append(idx)
        per_dim_sign.append(sgn)

    shp = lambda d: (nbox,) + tuple(S[k] if k == d else 1 for k in range(ndim))
    W = [per_dim_idx[d].reshape(shp(d)) for d in range(ndim)]       # wrapped
    SG = [per_dim_sign[d].reshape(shp(d)) for d in range(ndim)]

    own = _owner_array(ba, dlo, dshape)
    own_idx = tuple(np.broadcast_to(W[d] - dlo[d], (nbox,) + S)
                    for d in range(ndim))
    ob = own[own_idx]                                                # [nbox,*S]
    same = ob >= 0
    ob_safe = np.where(same, ob, 0)

    # flat index into fine data [nbox, *P] for the owning box's cell
    lo_of_owner = [ba.lo[:, d][ob_safe] for d in range(ndim)]
    local = [np.broadcast_to(W[d], (nbox,) + S) - lo_of_owner[d] for d in range(ndim)]
    flat = ob_safe.astype(np.int64)
    for d in range(ndim):
        flat = flat * P[d] + local[d]
    # cells not owned at this level: point at self-cell 0 (overwritten by crse)
    flat = np.where(same, flat, 0)

    sign_total = np.ones((nbox,) + S, dtype=np.int8)
    for d in range(ndim):
        sign_total = sign_total * SG[d]
    has_odd = (sign_total < 0).any()

    crse_src = crse_wt = use_crse = None
    crse_flat_len = 0
    if ba_crse is not None:
        Pc = tuple(pad_shape_crse)
        own_c = _owner_array(ba_crse, np.array(geom.domain.coarsen(ratio).lo),
                             np.array(geom.domain.coarsen(ratio).shape))
        dlo_c = np.array(geom.domain.coarsen(ratio).lo)
        need = ~same
        use_crse = need
        if interp == "pc":
            C = [np.floor_divide(np.broadcast_to(W[d], (nbox,) + S), ratio)
                 for d in range(ndim)]
            crse_src, found = _crse_flat(C, own_c, dlo_c, ba_crse, Pc,
                                         geom.is_periodic)
            if not bool(np.all(found[need])):
                raise ValueError(
                    "coarse-fine fill: ghost cells not covered by the coarse "
                    "BoxArray (improper nesting for this ngrow)")
        elif interp == "linear":
            # fine cell center in coarse index space: (W + 0.5)/ratio - 0.5
            base = []
            frac = []
            for d in range(ndim):
                xc = (np.broadcast_to(W[d], (nbox,) + S) + 0.5) / ratio - 0.5
                b0 = np.floor(xc).astype(np.int64)
                base.append(b0)
                frac.append((xc - b0).astype(np.float64))
            corners = []
            weights = []
            import itertools
            for offs in itertools.product((0, 1), repeat=ndim):
                C = [base[d] + offs[d] for d in range(ndim)]
                w = np.ones((nbox,) + S, dtype=np.float64)
                for d in range(ndim):
                    w = w * (frac[d] if offs[d] else (1.0 - frac[d]))
                flat_c, found = _crse_flat(C, own_c, dlo_c, ba_crse, Pc,
                                           geom.is_periodic)
                # corners outside the coarse union (interp stencil poking past
                # the union edge / domain face) lose their weight; surviving
                # corners are renormalized below — graceful degradation
                # toward piecewise-constant right at the union edge.
                w = np.where(found, w, 0.0)
                corners.append(flat_c)
                weights.append(w)
            wt = np.stack(weights, axis=-1)
            tot = wt.sum(axis=-1)
            bad = need & (tot <= 0.0)
            if bool(bad.any()):
                raise ValueError(
                    "coarse-fine fill: ghost cells entirely outside the "
                    "coarse BoxArray (improper nesting for this ngrow)")
            wt = wt / np.maximum(tot, 1e-300)[..., None]
            crse_src = np.stack(corners, axis=-1)
            crse_wt = wt
        else:
            raise ValueError(f"unknown interp {interp}")
        crse_flat_len = len(ba_crse) * int(np.prod(Pc))

    return FillPlan(
        same_src=jnp.asarray(flat, dtype=jnp.int32),
        sign=jnp.asarray(sign_total) if has_odd else None,
        use_crse=jnp.asarray(use_crse) if use_crse is not None else None,
        crse_src=jnp.asarray(crse_src, dtype=jnp.int32) if crse_src is not None else None,
        crse_wt=jnp.asarray(crse_wt, dtype=jnp.float32) if crse_wt is not None else None,
        ngrow=ngrow,
        grown_shape=S,
        fine_flat_len=nbox * int(np.prod(P)),
        crse_flat_len=crse_flat_len,
    )


def _crse_flat(C, own_c, dlo_c, ba_crse: BoxArray, Pc, periodic=()):
    """Flat indices into the coarse batched array for global coarse coords C.
    Returns (flat, found); uncovered cells get flat=0 and found=False."""
    ndim = len(C)
    dom_shape = own_c.shape
    Cc = []
    in_dom = np.ones(C[0].shape, dtype=bool)
    for d in range(ndim):
        c = C[d] - dlo_c[d]
        if d < len(periodic) and periodic[d]:
            c = c % dom_shape[d]
        else:
            in_dom &= (c >= 0) & (c < dom_shape[d])
            # fine-level W was already wrapped/BC-mapped into the domain; only
            # linear-interp corners can poke one cell past a domain face.
            c = np.clip(c, 0, dom_shape[d] - 1)
        Cc.append(c)
    ob = own_c[tuple(Cc)]
    found = (ob >= 0) & in_dom
    ob = np.where(found, ob, 0)
    flat = ob.astype(np.int64)
    for d in range(ndim):
        local = Cc[d] + dlo_c[d] - ba_crse.lo[:, d][ob]
        local = np.clip(local, 0, Pc[d] - 1)
        flat = flat * Pc[d] + local
    return flat, found


# ---------------------------------------------------------------------------
# Device-side application
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("ncomp_axis",))
def apply_fill(plan: FillPlan, fine: jnp.ndarray,
               crse: Optional[jnp.ndarray] = None,
               ncomp_axis: int = 1) -> jnp.ndarray:
    """fine: [nbox, ncomp, *pad_shape] -> grown [nbox, ncomp, *grown_shape]."""
    nbox, ncomp = fine.shape[0], fine.shape[1]
    fine_flat = jnp.moveaxis(fine, 1, 0).reshape(ncomp, -1)
    vals = jnp.take(fine_flat, plan.same_src.reshape(-1), axis=1)
    vals = vals.reshape((ncomp, nbox) + plan.grown_shape)
    if plan.crse_src is not None:
        if crse is None:
            raise ValueError("plan requires coarse data")
        crse_flat = jnp.moveaxis(crse, 1, 0).reshape(ncomp, -1)
        if plan.crse_wt is None:  # piecewise constant
            cvals = jnp.take(crse_flat, plan.crse_src.reshape(-1), axis=1)
            cvals = cvals.reshape((ncomp, nbox) + plan.grown_shape)
        else:  # linear: 2**D weighted corner gathers
            ncorner = plan.crse_src.shape[-1]
            cvals = 0.0
            for k in range(ncorner):
                g = jnp.take(crse_flat, plan.crse_src[..., k].reshape(-1), axis=1)
                g = g.reshape((ncomp, nbox) + plan.grown_shape)
                cvals = cvals + g * plan.crse_wt[..., k].astype(fine.dtype)
        vals = jnp.where(plan.use_crse[None], cvals, vals)
    if plan.sign is not None:
        vals = vals * plan.sign.astype(fine.dtype)[None]
    return jnp.moveaxis(vals, 0, 1)


# plan cache keyed by structural signature
_PLAN_CACHE: Dict[tuple, FillPlan] = {}


def get_fill_plan(ba, geom, ngrow, pad_shape, ba_crse=None, pad_shape_crse=None,
                  ratio=2, bc=None, interp="pc") -> FillPlan:
    key = (
        id(ba), id(ba_crse), ngrow, tuple(pad_shape),
        tuple(pad_shape_crse) if pad_shape_crse else None,
        ratio, bc, interp, geom.is_periodic, geom.domain.lo, geom.domain.hi,
    )
    if key not in _PLAN_CACHE:
        _PLAN_CACHE[key] = build_fill_plan(
            ba, geom, ngrow, pad_shape, ba_crse, pad_shape_crse, ratio, bc,
            interp)
    return _PLAN_CACHE[key]
