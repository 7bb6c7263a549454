"""Tracing/observability utilities (SURVEY.md §5 aux subsystems).

The reference uses BL_PROFILE scoped regions and hand-rolled wall-clock
phases with MPI min/max reductions (isosurface.cpp:1388-1424, 1756-1772;
StreamPC.cpp:41,90,267).  Here: named phase timers with the same style of
report, plus an opt-in jax.profiler trace wrapper.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Tuple

_PHASES: List[Tuple[str, float]] = []
VERBOSE = int(os.environ.get("PELE_VERBOSE", "0"))


@contextlib.contextmanager
def phase(name: str):
    """Scoped wall-clock phase (BL_PROFILE analog).  Accumulates into the
    module table; report() prints isosurface-style Max/Min lines."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _PHASES.append((name, dt))
        if VERBOSE:
            print(f"[phase] {name}: {dt*1e3:.2f} ms")


def report() -> Dict[str, float]:
    agg: Dict[str, float] = {}
    for name, dt in _PHASES:
        agg[name] = agg.get(name, 0.0) + dt
    for name, dt in agg.items():
        print(f"{name} time: {dt:.6f} s")
    return agg


def reset() -> None:
    _PHASES.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace (TensorBoard-viewable) around a code region."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def gpu_cards() -> str:
    """``name, power.limit`` of each GPU, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them.  Stays off JAX.  Raises RuntimeError where nvidia-smi is
    missing or lists no card."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    out = r.stdout.strip()
    if r.returncode != 0 or not out:
        raise RuntimeError(f"nvidia-smi lists no GPU (rc={r.returncode}): "
                           f"{r.stderr.strip()}")
    return out
