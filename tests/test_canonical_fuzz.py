"""Randomized sparse==dense parity fuzz for the canonical cluster frames.

Random scattered fine layouts — interior, face-, edge-, and corner-adjacent
clusters, random extents, ratio 2 and 4 — must produce EXACTLY the dense
run's answers through the canonical path (pinned/anchored boundary frames,
amr/canonical.py).  This is the broad-coverage net behind the targeted
cases in test_canonical.py; the reference gets the equivalent guarantee
from per-box ownership (/root/reference/Src/grad.cpp:160-163 + MFIter).
"""
import numpy as np
import pytest

from peleanalysis_tpu.amr.box import Box, BoxArray
from peleanalysis_tpu.amr.dense import DenseAmrState
from peleanalysis_tpu.amr.geometry import Geometry
from peleanalysis_tpu.amr.hierarchy import AmrMeta, AmrState
from peleanalysis_tpu.testing import make_level_data


def _random_state(seed, ratio, n_levels=2, periodic=False):
    """Random scattered hierarchy; finest boxes may hug any domain face.
    n_levels=3 adds a mid level (union of grown finest parents), so the
    canonical frames carry an INTERMEDIATE translated window too.
    periodic=True makes every dim periodic with boxes biased NEAR (>= 2
    cells clear of) the faces, so windows wrap-cross and exercise the
    wrap-cropped canonical frames; gate-rejected clusters exercise the
    legacy fallback — both must stay dense-exact."""
    rng = np.random.default_rng(seed)
    n0 = 24 if ratio == 2 else 16
    R = ratio ** (n_levels - 1)
    nf = n0 * R
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (periodic,) * 3)
    geoms = [geom0]
    for _ in range(n_levels - 1):
        geoms.append(geoms[-1].refine(ratio))
    boxes = []
    # up to 3 well-separated clusters at random (possibly boundary) spots
    anchors = rng.permutation([(0, 0, 0), (1, 1, 1), (2, 0, 2),
                               (0, 2, 1), (2, 2, 2), (1, 0, 0)])[:3]
    for a in anchors:
        ext = int(rng.integers(4, 9)) * R // 2
        lo = []
        for d in range(3):
            third = nf // 3
            base = a[d] * third
            # bias toward the domain edges so pinning paths fire often
            if a[d] == 0 and rng.random() < 0.5:
                lo.append(R if periodic else 0)
            elif a[d] == 2 and rng.random() < 0.5:
                lo.append(nf - ext - (R if periodic else 0))
            else:
                lo.append(int(rng.integers(base, base + third - ext)))
        lo = [(v // R) * R for v in lo]
        boxes.append(Box(tuple(lo), tuple(v + ext - 1 for v in lo)))
    ba_f = BoxArray(boxes)
    bas = [BoxArray([dom0])]
    # intermediate levels: DISJOINT blocky covers of the grown finest
    # parents (naive per-cluster grown parents can overlap when clusters
    # are near-adjacent — overlapping level boxes are invalid AMR input)
    from peleanalysis_tpu.amr.box import decompose
    for l in range(1, n_levels - 1):
        rl = ratio ** (n_levels - 1 - l)   # fine cells per level-l cell
        ldom = geoms[l].domain
        parents = [b.coarsen(rl).grow(2).intersect(ldom) for b in boxes]
        keep = [bb for bb in decompose(ldom, 8)
                if any(not bb.intersect(p).is_empty() for p in parents)]
        bas.append(BoxArray(keep))
    bas.append(ba_f)
    meta = AmrMeta(geoms, bas, [ratio] * (n_levels - 1))
    names, data = make_level_data(
        geoms, meta.bas,
        {"temp": lambda x, y, z: 300 + 1500 * (
            np.exp(-((x - .3) ** 2 + (y - .4) ** 2 + (z - .3) ** 2) / .02)
            + np.exp(-((x - .7) ** 2 + (y - .6) ** 2
                       + (z - .8) ** 2) / .02)) + 10 * x + 5 * y * z})
    return AmrState.from_arrays(meta, names, data, dtype=np.float64), ba_f


@pytest.mark.parametrize("seed,ratio,n_levels,periodic",
                         [(0, 2, 2, False), (1, 2, 2, False),
                          (2, 4, 2, False), (3, 2, 3, False),
                          (4, 4, 2, False), (5, 2, 3, False),
                          (6, 2, 4, False), (7, 2, 2, True),
                          (8, 2, 3, True), (9, 4, 2, True)])
def test_fuzz_sparse_grad_iso_match_dense(seed, ratio, n_levels, periodic):
    from peleanalysis_tpu.amr.canonical import (canonical_cluster_substates,
                                                global_frame)
    from peleanalysis_tpu.geom import marching_cubes as mc
    from peleanalysis_tpu.tools.grad import compute_grad_dense

    st, ba1 = _random_state(seed, ratio, n_levels, periodic)
    ds = DenseAmrState.from_batched(st)

    # --- grad: every cluster, every box, exact ---------------------------
    fin = st.meta.n_levels - 1
    ref = compute_grad_dense(ds, "temp", interp="quadratic")
    groups, subs, _, infos = canonical_cluster_substates(
        st, ngrow_max=1, interp_stencil=1)
    if not periodic:
        assert all(i.canonical for i in infos)   # non-periodic: always
    # periodic: wrap-gated clusters legitimately fall back to legacy —
    # both paths must match dense below
    rb = ref.lmeta[fin].bbox
    boxes = list(ba1)
    c = ref.comp("||gradtemp||")
    for g, sub, info in zip(groups, subs, infos):
        out = global_frame(compute_grad_dense(sub, "temp",
                                              interp="quadratic"), info)
        wb = out.lmeta[fin].bbox
        co = out.comp("||gradtemp||")
        for bi in g:
            bx = boxes[bi]
            slw = tuple(slice(bx.lo[d] - wb.lo[d], bx.hi[d] - wb.lo[d] + 1)
                        for d in range(3))
            slr = tuple(slice(bx.lo[d] - rb.lo[d], bx.hi[d] - rb.lo[d] + 1)
                        for d in range(3))
            a = np.asarray(out.data[fin][co])[slw]
            b = np.asarray(ref.data[fin][c])[slr]
            np.testing.assert_allclose(a, b, atol=1e-12,
                                       err_msg=f"seed={seed} box={bi}")

    # --- isosurface: node/element set equality ---------------------------
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


@pytest.mark.parametrize("seed,ratio,n_levels", [(1, 2, 2), (3, 2, 3)])
def test_fuzz_sparse_stream_matches_dense(seed, ratio, n_levels):
    """Random layouts: canonical sparse streamline tracing == dense march
    (seeds near every cluster + coarse-owned seeds)."""
    from peleanalysis_tpu.stream.trace import (trace_streamlines,
                                               trace_streamlines_sparse)

    st, ba1 = _random_state(seed, ratio, n_levels)
    fin = st.meta.n_levels - 1
    geomf = st.meta.geoms[fin]
    nf = geomf.domain.shape[0]
    rng = np.random.default_rng(seed + 100)
    seeds = [0.5 + 0.4 * (rng.random((4, 3)) - 0.5)]      # coarse-owned-ish
    for b in ba1:
        c = (np.array(b.lo) + np.array(b.hi) + 1) / 2.0 / nf
        seeds.append(c + 0.02 * (rng.random((4, 3)) - 0.5))
    seeds = np.concatenate(seeds)
    ref = trace_streamlines(DenseAmrState.from_batched(st), seeds, 13, 0.5,
                            trace_field="temp")
    sp = trace_streamlines_sparse(st, seeds, 13, 0.5, trace_field="temp")
    np.testing.assert_allclose(sp, ref, atol=1e-9)


@pytest.mark.parametrize("seed,ratio,n_levels", [(0, 2, 2), (5, 2, 3)])
def test_fuzz_sparse_stats_match_dense(seed, ratio, n_levels):
    """Random layouts: the sparse conditionalMean accumulation (coarse part
    + per-cluster finest parts, ratio^ndim rescale) == dense."""
    from peleanalysis_tpu.amr.cluster import sparse_stats_parts
    from peleanalysis_tpu.tools.conditional_mean import (
        accumulate_conditional_mean)

    st, _ = _random_state(seed, ratio, n_levels)
    ds = DenseAmrState.from_batched(st)
    args = ("temp", ["temp"], 32, 300.0, 1801.0, True)
    ref = accumulate_conditional_mean(ds, *args)
    ds_c, clusters, r = sparse_stats_parts(st)
    parts = [(ds_c, float(r ** 3))] + [(c, 1.0) for c in clusters]
    acc = None
    for dsp, scale in parts:
        h, s, s2, mn, mx = accumulate_conditional_mean(dsp, *args)
        if acc is None:
            acc = [scale * h, scale * s, scale * s2, mn, mx]
        else:
            acc[0] += scale * h
            acc[1] += scale * s
            acc[2] += scale * s2
            acc[3] = np.minimum(acc[3], mn)
            acc[4] = np.maximum(acc[4], mx)
    for x, y, tag in zip(ref, acc, ("hits", "sums", "sumsq", "min", "max")):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-10, atol=1e-9, err_msg=tag)
