import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
# exercised without accelerator hardware (SURVEY.md §4).  JAX_PLATFORMS
# defaults to cpu; the GPU-marked tests run on the card with
# JAX_PLATFORMS=cuda (see README, "Running on a GPU").
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# Numerics-parity tests compare against float64 references; enable x64 so the
# requested dtype is honored (production runs float32 — dtype-agnostic
# library code is exercised either way).
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def synthetic_plotfile(tmp_path_factory):
    from peleanalysis_tpu.testing import write_synthetic_plotfile

    path = str(tmp_path_factory.mktemp("plt") / "plt00000")
    geoms, bas, ratios, names, data = write_synthetic_plotfile(path)
    return {
        "path": path, "geoms": geoms, "bas": bas, "ratios": ratios,
        "names": names, "data": data,
    }


@pytest.fixture(scope="session")
def periodic_plotfile(tmp_path_factory):
    from peleanalysis_tpu.testing import write_synthetic_plotfile

    path = str(tmp_path_factory.mktemp("pltper") / "plt00000")
    out = write_synthetic_plotfile(path, is_periodic=(True, True, True))
    geoms, bas, ratios, names, data = out
    return {
        "path": path, "geoms": geoms, "bas": bas, "ratios": ratios,
        "names": names, "data": data,
    }
