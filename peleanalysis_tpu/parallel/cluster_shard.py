"""Cluster-axis SPMD: equal-bucket canonical clusters as ONE batched
dispatch, sharded over a device mesh.

The reference's sparse-AMR scaling comes from DistributionMapping: each MPI
rank owns a subset of the finest level's boxes and runs the same compiled
kernel on its patches (/root/reference/Src/grad.cpp:160-163 + MFIter).  The
JAX analog: canonical-frame cluster substates (amr/canonical.py) are
shape-identical within a bucket, so K clusters stack on a leading batch
axis, the per-cluster engine is ``jax.vmap``-ed over it, and the batch axis
is sharded over a 1-D ``clusters`` mesh.  Every op inside the vmapped core
carries the batch dim, so GSPMD partitions the dispatch embarrassingly
parallel — no collectives; each device owns ceil(K/n) clusters and memory
per device scales with its share (instead of a dense fallback whose
footprint is the union bounding box).

Single-device use is also supported (``mesh=None``): K engine dispatches
collapse into one dispatch and one fetch.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

CLUSTER_AXIS = "clusters"


def cluster_mesh(n_devices: int):
    """1-D mesh over the cluster axis (the DistributionMapping rank set)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n_devices]), (CLUSTER_AXIS,))


# cross-instance batched-engine cache (see amr/dense.shared_engine)
_GLOBAL_BATCH_FNS: dict = {}


def run_clusters_batched(subs: Sequence, infos: Sequence, core_key,
                         core_builder: Callable, mesh=None,
                         inputs_select: Optional[Callable] = None,
                         extra_args: Sequence = ()
                         ) -> List[Optional[list]]:
    """Run a per-cluster engine over all CANONICAL clusters as bucket-stacked
    vmapped dispatches.

    core_builder(template_sub) must return a PURE function
    ``fn(*stacked_inputs, *extra_args) -> [per-level output arrays]`` that
    closes over the template's meta/lmeta only (never its device data — the
    cross-instance cache would pin it).  ``inputs_select(sub)`` returns the
    tuple of per-cluster input pytrees; each is stacked across clusters on
    a new leading axis (default: ``(data levels, in_level masks)``).
    ``extra_args`` are shared across clusters (vmapped with in_axes=None),
    e.g. traced scalar bounds that must not bake into the jaxpr.

    Returns ``outs`` with one entry per sub: canonical entries are lists of
    per-level device arrays (rows of the sharded batch result); legacy
    (boundary-cluster) entries are None — the caller runs its round-3
    serial fallback on those.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..amr.dense import hier_fingerprint, shared_engine

    if inputs_select is None:
        inputs_select = lambda sub: (
            list(sub.data),
            [sub.in_level_mask(l) for l in range(sub.meta.n_levels)])
    outs: List[Optional[list]] = [None] * len(subs)
    buckets: dict = {}
    for i, (sub, info) in enumerate(zip(subs, infos)):
        if info.canonical:
            buckets.setdefault(hier_fingerprint(sub), []).append(i)
    ndev = int(mesh.devices.size) if mesh is not None else 1
    sh = NamedSharding(mesh, P(CLUSTER_AXIS)) if mesh is not None else None
    for idx in buckets.values():
        tpl = subs[idx[0]]
        K = len(idx)
        # pad the batch to the mesh size by repeating clusters (inert: the
        # pad rows' outputs are never read back)
        Kp = ((K + ndev - 1) // ndev) * ndev
        reps = [idx[j % K] for j in range(Kp)]
        per = [inputs_select(subs[j]) for j in reps]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *per)
        if sh is not None:
            stacked = jax.tree.map(lambda a: jax.device_put(a, sh), stacked)
        core = core_builder(tpl)
        n_in = len(stacked)
        in_axes = (0,) * n_in + (None,) * len(extra_args)
        fn = shared_engine(_GLOBAL_BATCH_FNS, 16, tpl,
                           (core_key, Kp, ndev),
                           lambda: jax.jit(jax.vmap(core, in_axes=in_axes)))
        res = fn(*stacked, *extra_args)
        for j, i_s in enumerate(idx):
            outs[i_s] = [r[j] for r in res]
    return outs
