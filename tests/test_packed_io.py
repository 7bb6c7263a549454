"""Packed flat-fetch plotfile writers and jitted dense assembly produce
byte-identical plotfiles to the eager host paths.

On non-CPU backends the writers fetch ONE flat device vector (instead of one
padded 5-D fetch per level) and the box assembly/scatter loops run as one
jitted dispatch.  These tests force those paths on the CPU backend and pin
exact output parity (r4)."""
import os

import numpy as np
import pytest

from peleanalysis_tpu.amr import dense as dense_mod
from peleanalysis_tpu.amr import hierarchy as hier_mod
from peleanalysis_tpu.amr.dense import DenseAmrState
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.testing import write_synthetic_plotfile


def _read_tree(path):
    out = {}
    for root, _dirs, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, path)] = open(p, "rb").read()
    return out


@pytest.fixture
def forced_packed(monkeypatch):
    monkeypatch.setattr(dense_mod, "_DISPATCH_COSTLY", True)
    monkeypatch.setattr(hier_mod, "_FORCE_PACKED_FETCH", True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_writer_packed_parity(tmp_path, forced_packed, dtype):
    src = str(tmp_path / "plt_in")
    write_synthetic_plotfile(src, n_cell=16, n_levels=3)
    st = AmrState.from_plotfile(src, dtype=dtype)

    hier_mod._FORCE_PACKED_FETCH = False
    dense_mod._DISPATCH_COSTLY = False
    st.to_plotfile(str(tmp_path / "plt_ref"))
    hier_mod._FORCE_PACKED_FETCH = True
    dense_mod._DISPATCH_COSTLY = True
    st.to_plotfile(str(tmp_path / "plt_packed"))

    ref = _read_tree(str(tmp_path / "plt_ref"))
    got = _read_tree(str(tmp_path / "plt_packed"))
    assert ref.keys() == got.keys()
    for k in ref:
        assert ref[k] == got[k], f"{k} differs"


def test_dense_writer_packed_parity(tmp_path, forced_packed):
    src = str(tmp_path / "plt_in")
    write_synthetic_plotfile(src, n_cell=16, n_levels=2)
    ds_ref = DenseAmrState.from_plotfile(src, dtype=np.float32)

    dense_mod._DISPATCH_COSTLY = False
    hier_mod._FORCE_PACKED_FETCH = False
    ds_ref.to_plotfile(str(tmp_path / "plt_ref"))
    dense_mod._DISPATCH_COSTLY = True
    hier_mod._FORCE_PACKED_FETCH = True
    # a fresh state through the JITTED assembly path as well
    ds_jit = DenseAmrState.from_plotfile(src, dtype=np.float32)
    ds_jit.to_plotfile(str(tmp_path / "plt_packed"))

    ref = _read_tree(str(tmp_path / "plt_ref"))
    got = _read_tree(str(tmp_path / "plt_packed"))
    assert ref.keys() == got.keys()
    for k in ref:
        assert ref[k] == got[k], f"{k} differs"


def test_jitted_assembly_matches_eager(tmp_path, forced_packed):
    src = str(tmp_path / "plt_in")
    write_synthetic_plotfile(src, n_cell=16, n_levels=2)
    st = AmrState.from_plotfile(src, dtype=np.float32)

    dense_mod._DISPATCH_COSTLY = False
    ref = DenseAmrState.from_batched(st)
    dense_mod._DISPATCH_COSTLY = True
    jit = DenseAmrState.from_batched(st)
    for lev in range(st.meta.n_levels):
        np.testing.assert_array_equal(np.asarray(ref.data[lev]),
                                      np.asarray(jit.data[lev]))
    # scatter (to_batched) round-trip too
    dense_mod._DISPATCH_COSTLY = False
    rb_ref = ref.to_batched()
    dense_mod._DISPATCH_COSTLY = True
    rb_jit = jit.to_batched()
    for lev in range(st.meta.n_levels):
        np.testing.assert_array_equal(np.asarray(rb_ref.data[lev]),
                                      np.asarray(rb_jit.data[lev]))


def test_dense_writer_2d(tmp_path, forced_packed):
    src = str(tmp_path / "plt2d")
    write_synthetic_plotfile(src, n_cell=16, n_levels=2, ndim=2)
    ds = DenseAmrState.from_plotfile(src, dtype=np.float32)
    dense_mod._DISPATCH_COSTLY = False
    hier_mod._FORCE_PACKED_FETCH = False
    ds.to_plotfile(str(tmp_path / "ref2d"))
    dense_mod._DISPATCH_COSTLY = True
    hier_mod._FORCE_PACKED_FETCH = True
    ds.to_plotfile(str(tmp_path / "packed2d"))
    ref = _read_tree(str(tmp_path / "ref2d"))
    got = _read_tree(str(tmp_path / "packed2d"))
    assert ref.keys() == got.keys()
    for k in ref:
        assert ref[k] == got[k], f"{k} differs"
