"""peleanalysis-tpu: a JAX AMR post-processing framework with the
capabilities of AMReX-Combustion/PeleAnalysis (see README.md).

Public API: the two in-memory AMR models, the I/O layer, and the engines.
Tools are invoked via ``python -m peleanalysis_tpu <tool> key=value...``.
"""

__version__ = "0.4.0"

from .amr.box import Box, BoxArray, decompose
from .amr.geometry import Geometry
from .amr.hierarchy import AmrMeta, AmrState
from .amr.dense import DenseAmrState

__all__ = [
    "Box", "BoxArray", "decompose", "Geometry", "AmrMeta", "AmrState",
    "DenseAmrState",
    # io (imported lazily below)
    "PlotfileReader", "write_plotfile", "MEF", "read_mef", "write_mef",
    "StreamData", "read_stream_data", "write_stream_data",
    # engines
    "extract_isosurface", "extract_isolines", "trace_streamlines",
    "cg_solve", "cg_solve_composite", "average_down_all",
    "fill_dense_multilevel",
]


def __getattr__(name):
    # lazy imports keep `import peleanalysis_tpu` light
    lazy = {
        "PlotfileReader": ("peleanalysis_tpu.io.plotfile", "PlotfileReader"),
        "write_plotfile": ("peleanalysis_tpu.io.plotfile", "write_plotfile"),
        "MEF": ("peleanalysis_tpu.io.mef", "MEF"),
        "read_mef": ("peleanalysis_tpu.io.mef", "read_mef"),
        "write_mef": ("peleanalysis_tpu.io.mef", "write_mef"),
        "StreamData": ("peleanalysis_tpu.io.stream_data", "StreamData"),
        "read_stream_data": ("peleanalysis_tpu.io.stream_data",
                             "read_stream_data"),
        "write_stream_data": ("peleanalysis_tpu.io.stream_data",
                              "write_stream_data"),
        "extract_isosurface": ("peleanalysis_tpu.geom.marching_cubes",
                               "extract_isosurface"),
        "extract_isolines": ("peleanalysis_tpu.geom.marching_squares",
                             "extract_isolines"),
        "trace_streamlines": ("peleanalysis_tpu.stream.trace",
                              "trace_streamlines"),
        "cg_solve": ("peleanalysis_tpu.ops.solve", "cg_solve"),
        "cg_solve_composite": ("peleanalysis_tpu.ops.solve",
                               "cg_solve_composite"),
        "average_down_all": ("peleanalysis_tpu.ops.restrict",
                             "average_down_all"),
        "fill_dense_multilevel": ("peleanalysis_tpu.ops.dense_fill",
                                  "fill_dense_multilevel"),
    }
    if name in lazy:
        import importlib

        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'peleanalysis_tpu' has no attribute "
                         f"{name!r}")
