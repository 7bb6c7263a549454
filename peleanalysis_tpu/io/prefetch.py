"""Read-ahead plotfile iteration for multi-file (time-series) tools.

The reference's multi-file statistics tools walk their plotfile list
strictly serially — parse file i, compute, write, parse file i+1
(/root/reference/Src/conditionalMean.cpp:114-320, jpdf.cpp main loop).  On
this framework the device computes while the HOST sits idle; :func:`iter_states` fills that idle time by
parsing + uploading file i+1 on a background thread while the caller is
still crunching file i — the input-side twin of the Session's async
write-back (session.py).  The classic accelerator input-pipeline pattern
(tf.data/pjit data prefetch), applied to plotfile series.

One worker, depth-1 read-ahead: plotfiles are large (the host-side FAB
parse is the cost being hidden), so deeper queues only grow peak host
memory — depth 1 already makes the steady-state per-file wall time
``max(host_parse, device_compute)`` instead of their sum.

Session semantics: loads go through session.load_state with cache=False —
registered in-memory outputs still shadow their paths and an
already-cached state is reused, but series members are never INSERTED
into the session cache (a long server run over many ensembles must not
pin every member's device state).  The worker thread only ever touches
the NEXT path while the consumer holds the current one.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

from ..amr.hierarchy import AmrState


def iter_states(args: dict, paths: Sequence[str], names=None,
                max_level=None, is_periodic=None, dtype=None,
                depth: int = 1) -> Iterator[Tuple[str, AmrState]]:
    """Yield ``(path, AmrState)`` over ``paths`` with ``depth``-file
    read-ahead on a background thread (depth<=0 or a single path falls back
    to the plain serial loop).  ``names`` may be a callable ``path ->
    comp names`` for series whose files carry different component sets
    (resolved on the worker — a header parse is cheap next to the FABs).
    Worker exceptions surface on the yield of the file that failed, in
    order."""
    from ..session import load_state

    def load(p):
        n = names(p) if callable(names) else names
        # cache=False: a time-series sweep must stream — pinning every
        # member's device state in the session would make "peak memory ~2
        # inputs" silently become "the whole ensemble" under serve/pipeline
        return load_state(args, p, names=n, max_level=max_level,
                          is_periodic=is_periodic, dtype=dtype, cache=False)

    paths = list(paths)
    if depth <= 0 or len(paths) <= 1:
        for p in paths:
            yield p, load(p)
        return

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    ex = ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="pele-prefetch")
    try:
        pending = deque()
        nxt = 0
        # exactly `depth` loads in flight beyond the file the consumer
        # holds (the refill below happens before the yield): peak residency
        # is depth+1 files, matching the documented "~2 inputs" at depth 1
        while nxt < len(paths) and len(pending) < depth:
            pending.append((paths[nxt], ex.submit(load, paths[nxt])))
            nxt += 1
        while pending:
            p, fut = pending.popleft()
            st = fut.result()   # re-raises a worker parse failure in order
            if nxt < len(paths):
                pending.append((paths[nxt], ex.submit(load, paths[nxt])))
                nxt += 1
            yield p, st
    finally:
        # a consumer that stops early (exception mid-series) must not leave
        # the worker running against files it will never use
        ex.shutdown(wait=False, cancel_futures=True)


def query_prefetch(pp) -> int:
    """Shared ParmParse key for the multi-file tools: ``prefetch=N`` files
    of read-ahead (default 1; 0 restores the serial loop)."""
    return pp.query_int("prefetch", 1)
