"""Explicit ring halo exchange via shard_map + ppermute.

GSPMD handles the dense model's sharded slicing automatically
(parallel/dense_shard.py), but for production multi-chip stencils an
explicit neighbor exchange is one collective per side: each shard sends its
boundary planes to its ring neighbors with collective-permutes — the
FillBoundary analog (SURVEY.md §2.7 item 2) with no compiler guesswork.

``halo_grad_x``: a shard_map'd gradient+magnitude whose only communication
is two ppermutes of g boundary planes; numerically identical to the global
computation (tests/test_halo.py).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map


def halo_exchange(local: jnp.ndarray, g: int, axis_name: str,
                  dim: int) -> jnp.ndarray:
    """Grow a shard by g planes per side along spatial dim `dim` (0..2 of a
    [C, X, Y, Z] array), filled from ring neighbors over mesh axis
    `axis_name` (wraparound at the ends; callers overwrite physical-BC
    layers on the boundary shards).  The general FillBoundary analog
    (SURVEY.md §2.7 item 2) for any sharded axis."""
    ax = dim + 1
    n = jax.lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]

    def sl(s):
        idx = [slice(None)] * local.ndim
        idx[ax] = s
        return tuple(idx)

    from_left = jax.lax.ppermute(local[sl(slice(-g, None))], axis_name, fwd)
    from_right = jax.lax.ppermute(local[sl(slice(0, g))], axis_name, bwd)
    return jnp.concatenate([from_left, local, from_right], axis=ax)


def _exchange_x(local: jnp.ndarray, g: int, axis_name: str) -> jnp.ndarray:
    return halo_exchange(local, g, axis_name, 0)


def halo_grad(arr: jnp.ndarray, dx, mesh: Mesh, axis_specs) -> jnp.ndarray:
    """Gradient + |grad| of a dense [1, X, Y, Z] array sharded along ANY
    subset of spatial dims.  axis_specs: tuple of mesh-axis-name-or-None per
    spatial dim, e.g. ("x", None, None) or ("x", "y", None) for a 2-D mesh.
    Non-periodic boundaries use first-order extrapolation (grad.cpp:136-144
    default).  Returns [4, X, Y, Z] with the same sharding."""
    inv2 = tuple(1.0 / (2.0 * d) for d in dx)

    def shard_fn(local):
        grown = local
        for d in range(3):
            name = axis_specs[d]
            ax = d + 1
            if name is None:
                pads = [(0, 0)] * 4
                pads[ax] = (1, 1)
                grown = jnp.pad(grown, pads, mode="edge")
                continue
            me = jax.lax.axis_index(name)
            n = jax.lax.axis_size(name)
            grown = halo_exchange(grown, 1, name, d)

            def face(i):
                idx = [slice(None)] * 4
                idx[ax] = i
                return tuple(idx)

            # physical BC (foextrap) on the outermost shards
            grown = jnp.where(me == 0,
                              grown.at[face(0)].set(grown[face(1)]), grown)
            grown = jnp.where(me == n - 1,
                              grown.at[face(-1)].set(grown[face(-2)]),
                              grown)
        c = grown[0]
        gx = (c[2:, 1:-1, 1:-1] - c[:-2, 1:-1, 1:-1]) * inv2[0]
        gy = (c[1:-1, 2:, 1:-1] - c[1:-1, :-2, 1:-1]) * inv2[1]
        gz = (c[1:-1, 1:-1, 2:] - c[1:-1, 1:-1, :-2]) * inv2[2]
        mag = jnp.sqrt(gx * gx + gy * gy + gz * gz)
        return jnp.stack([gx, gy, gz, mag])

    spec = P(None, *axis_specs)
    fn = shard_map(shard_fn, mesh=mesh, in_specs=(spec,), out_specs=spec)
    return jax.jit(fn)(arr)


def halo_grad_x(arr: jnp.ndarray, dx: Tuple[float, float, float],
                mesh: Mesh, axis_name: str = "x") -> jnp.ndarray:
    """Gradient + |grad| of a dense [C=1, X, Y, Z] array sharded along X,
    with explicit ppermute halo exchange.  Non-periodic x boundaries use
    first-order extrapolation (grad.cpp:136-144 default); y/z likewise.
    Returns [4, X, Y, Z] with the same sharding."""
    inv2 = tuple(1.0 / (2.0 * d) for d in dx)

    def shard_fn(local):
        me = jax.lax.axis_index(axis_name)
        n = jax.lax.axis_size(axis_name)
        grown = _exchange_x(local, 1, axis_name)
        # physical BC on the outermost shards (foextrap: edge replicate)
        grown = jnp.where(me == 0,
                          grown.at[:, 0].set(grown[:, 1]), grown)
        grown = jnp.where(me == n - 1,
                          grown.at[:, -1].set(grown[:, -2]), grown)
        # y/z ghosts: local edge pads
        grown = jnp.pad(grown, ((0, 0), (0, 0), (1, 1), (1, 1)),
                        mode="edge")
        c = grown[0]
        gx = (c[2:, 1:-1, 1:-1] - c[:-2, 1:-1, 1:-1]) * inv2[0]
        gy = (c[1:-1, 2:, 1:-1] - c[1:-1, :-2, 1:-1]) * inv2[1]
        gz = (c[1:-1, 1:-1, 2:] - c[1:-1, 1:-1, :-2]) * inv2[2]
        mag = jnp.sqrt(gx * gx + gy * gy + gz * gz)
        return jnp.stack([gx, gy, gz, mag])

    spec = P(None, axis_name)
    fn = shard_map(shard_fn, mesh=mesh, in_specs=(spec,), out_specs=spec)
    return jax.jit(fn)(arr)
