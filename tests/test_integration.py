"""End-to-end workflow: plotfile -> grad -> curvature -> isosurface ->
streamlines -> tube stats -> decimation -> VTK, all through the CLI —
the way a reference user would chain the executables."""
import os

import numpy as np
import pytest

from peleanalysis_tpu.cli import main
from peleanalysis_tpu.io.mef import read_mef
from peleanalysis_tpu.io.plotfile import PlotfileReader
from peleanalysis_tpu.testing import write_synthetic_plotfile


def test_full_chain(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    plt = "plt00000"
    write_synthetic_plotfile(plt, n_cell=32, n_levels=2)

    # 1. gradient
    assert main(["grad", f"infile={plt}", "gradVar=temp",
                 "outfile=plt_gt"]) == 0
    assert "||gradtemp||" in PlotfileReader("plt_gt").var_names

    # 2. curvature
    assert main(["curvature", f"infile={plt}", "progressName=progress",
                 "do_gaussCurv=1", "outfile=plt_K"]) == 0
    assert "MeanCurvature_progress" in PlotfileReader("plt_K").var_names

    # 3. isosurface (with verbose phase report)
    assert main(["isosurface", f"infile={plt}", "isoCompName=progress",
                 "isoVal=0.5", "comps=temp", "outfile_base=surf",
                 "computeArea=1", "verbose=1"]) == 0
    surf = read_mef("surf.mef")
    assert surf.n_elts > 100

    # 4. decimate the seed surface
    assert main(["decimateMEF", "infile=surf.mef",
                 f"face_target={surf.n_elts // 4}",
                 "outfile=surf_dec.mef"]) == 0
    dec = read_mef("surf_dec.mef")
    assert dec.n_elts < surf.n_elts

    # 5. streamlines from the decimated surface
    assert main(["stream", f"plotfile={plt}", "progressName=progress",
                 "isoFile=surf_dec.mef", "nRKsteps=11", "hRK=0.5",
                 "streamFile=sd", "aux_comps=temp"]) == 0

    # 6. sample another field onto the lines
    assert main(["sampleStreamlines", f"plotfile={plt}", "pathFile=sd",
                 "comps=density", "streamSampleFile=sd2"]) == 0

    # 7. tube statistics -> element MEF
    assert main(["streamTubeStats", "infile=sd", "intComps=progress",
                 "avgComps=progress", "outfile=tube"]) == 0
    tube = read_mef("tube.mef")
    assert "volume" in tube.names

    # 8. binned statistics on the original plotfile
    assert main(["conditionalMean", f"infile={plt}", "binComp=progress",
                 "avgComps=temp", "nBins=16", "binMin=0", "binMax=1"]) == 0
    assert os.path.exists("CM_progress.dat")

    # 9. convert the surface for ParaView
    from peleanalysis_tpu.io.vtk import write_vtp
    write_vtp("surf.vtp", surf)
    assert os.path.getsize("surf.vtp") > 1000


def test_doctor_runs_and_probes(capsys):
    """doctor reports the backend (probed in-process), the compile cache
    and the native library, and completes rc=0 on the CPU backend."""
    from peleanalysis_tpu.cli import main

    assert main(["doctor"]) == 0
    out = capsys.readouterr().out
    assert "backend:   cpu" in out and "compile cache:" in out
