"""``doctor`` — environment diagnostics for support and bug reports.

No reference analog (the reference's build system surfaces configuration
at compile time); a JIT-compiled framework needs a runtime equivalent:
which backend will execute, how many devices, where the persistent
compile cache lives, and whether the native helper library builds.
"""
from __future__ import annotations

import os


def main(args: dict) -> None:
    import jax

    import peleanalysis_tpu
    from ..config import compile_cache_dir

    print("peleanalysis_tpu doctor")
    print(f"  package:   {os.path.dirname(peleanalysis_tpu.__file__)}")
    print(f"  jax:       {jax.__version__}")
    import numpy as np
    print(f"  numpy:     {np.__version__}")
    devs = []
    try:
        devs = jax.devices()
        print(f"  backend:   {jax.default_backend()} "
              f"({len(devs)} device(s): {devs[0].device_kind})")
    except Exception as e:  # no usable backend
        print(f"  backend:   UNAVAILABLE ({type(e).__name__}: {e})")
    print(f"  x64:       {jax.config.jax_enable_x64}")
    cache = compile_cache_dir() or os.environ["JAX_COMPILATION_CACHE_DIR"]
    print(f"  compile cache: {cache} "
          f"({'exists' if os.path.isdir(cache) else 'will be created'})")
    try:
        from ..native import get_lib
        get_lib()
        print("  native lib: OK (qem + vismf loader)")
    except Exception as e:
        print(f"  native lib: build failed ({type(e).__name__}: {e})")
    if devs:
        import time

        import jax.numpy as jnp
        x = jnp.ones((256, 256))
        t0 = time.perf_counter()
        _ = float(jnp.sum(x @ x))
        print(f"  smoke matmul: OK ({(time.perf_counter()-t0)*1e3:.0f} ms "
              "incl. first compile)")
