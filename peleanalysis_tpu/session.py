"""Device-resident pipeline session.

The reference chains its tools through files: each main() re-reads the
plotfile, re-fills ghosts, and writes its whole output to disk
(PeleAnalysis Src/GNUmakefile:14-40 — one executable per analysis).  A
file-chained run repeats every load, upload and fetch, so the ``pipeline``
CLI mode (cli.py) threads one :class:`Session` through the tool mains:

  * plotfile loads are cached per (path, max_level, is_per, dtype) and
    extended IN PLACE when a later stage needs more components — the batched
    device arrays, the DenseAmrState, and its compiled-engine caches
    (``_mc_enum_fns`` etc.) all survive, so nothing re-reads, re-fills, or
    recompiles;
  * tool outputs (plotfiles, MEF surfaces, streamline sets) are registered
    under their output names; a later stage asking for that name gets the
    in-memory object instead of parsing the file back;
  * per-stage ``write=0`` skips the disk artifact entirely — the data stays
    on device for the next stage, and only final artifacts are fetched.

Python API::

    from peleanalysis_tpu.session import Session
    s = Session()
    s.run("grad", infile="plt", gradVar="temp", outfile="g")
    s.run("isosurface", infile="plt", isoCompName="temp", isoVal=1000,
          outfile_base="iso", write=0)
    s.run("stream", plotfile="plt", isoFile="iso.mef", outFile="lines.dat")
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .amr.dense import DenseAmrState
from .amr.hierarchy import AmrState


def _state_key(path: str, max_level, is_periodic, dtype) -> Tuple:
    from jax.dtypes import canonicalize_dtype

    from . import config
    per = tuple(bool(p) for p in is_periodic) if is_periodic is not None \
        else None
    # key by the EFFECTIVE on-device dtype: tools that request float64 get
    # float32 arrays when x64 is off, identical to a float32 load — sharing
    # the cache entry is exact, not approximate
    dt = canonicalize_dtype(np.dtype(dtype or config.compute_dtype)).name
    return (path, max_level, per, dt)


def _header_mtime(path: str):
    """Header mtime: a long-lived Session (or a pipeline whose stage
    rewrites an input path) must not serve stale device arrays after the
    plotfile changed on disk.  Stored NEXT TO the cached state (not in the
    key) so a rewrite EVICTS the superseded entry instead of leaking one
    device-resident state per rewrite."""
    try:
        return os.path.getmtime(os.path.join(path, "Header"))
    except OSError:
        return None


class Session:
    """Shared state across chained tool invocations (see module docstring).

    async_writes=True (the pipeline CLI and the server set it) lets stage
    plotfile writes run as WRITE-BACK: the device->host transfer is
    initiated with ``copy_to_host_async`` and the host-side slicing + FAB
    write run on a single background thread, so the next stage's device
    compute overlaps the previous stage's output fetch — the choreography
    a chained reference run gets from the OS page cache + MPI-IO for free.
    Ordering: one worker thread = writes complete in submission order; any
    consumer that might READ a pending path from disk must
    ``flush_writes(match=argv)`` first (the pipeline driver and the server
    do).  The Python-API default stays synchronous."""

    def __init__(self, async_writes: bool = False) -> None:
        import threading
        self._states: Dict[Tuple, Tuple] = {}   # key -> (Header mtime, state)
        self._dense: Dict[Tuple, DenseAmrState] = {}
        # retain every state we keyed by id(): without this, a replaced
        # registry entry could be GC'd and its id recycled by a NEW state,
        # making _dense serve another state's cached arrays
        self._retain: Dict[int, AmrState] = {}
        self.plotfiles: Dict[str, AmrState] = {}   # output name -> state
        self.surfaces: Dict[str, object] = {}      # output name -> MEF
        self.lines: Dict[str, tuple] = {}          # name -> (names, lines,
        #                                            elements)
        self.async_writes = bool(async_writes)
        self._wb_pool = None
        self._wb: List[Tuple[str, object]] = []    # (path, Future)
        self._var_names: Dict[Tuple, List[str]] = {}  # (path, mtime) -> vars
        # guards the cache dicts against the prefetch worker thread
        # (io/prefetch.py runs session.load concurrently; r5 review fix:
        # an mtime eviction could `del` while the main thread iterates).
        # The heavy work (file parse, device upload) stays OUTSIDE the
        # lock so prefetch overlap is preserved.
        self._cache_lock = threading.RLock()

    # -- async write-back ----------------------------------------------------

    def submit_write(self, path: str, thunk) -> None:
        """Queue a host-side write (device transfer already initiated by the
        caller via copy_to_host_async) on the single write-back thread."""
        if self._wb_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._wb_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pele-writeback")
        # a rewrite of the same path must not race its predecessor
        self.flush_writes(match=[path])
        self._wb.append((path, self._wb_pool.submit(thunk)))

    def flush_writes(self, match: Optional[Sequence[str]] = None) -> None:
        """Wait for pending writes and re-raise the first failure.
        match: only flush writes whose output path is named by one of the
        given strings (e.g. the next stage's argv); None = all.  Matching is
        by normalized path equality over the strings' path-like tokens (so
        './out', 'out' and an absolute spelling all settle the same pending
        write), with a raw-substring fallback — over-flushing is safe,
        missing a flush means reading a half-written file."""
        toks = None
        if match is not None:
            toks = set()
            for m in match:
                for t in str(m).replace("=", " ").split():
                    toks.add(os.path.abspath(t))

        def hits(p):
            return (match is None or os.path.abspath(p) in toks
                    or any(p in m for m in match))

        with self._cache_lock:
            take = [(p, f) for p, f in self._wb if hits(p)]
            self._wb = [(p, f) for p, f in self._wb if not hits(p)]
        err = None
        for p, fut in take:
            try:
                fut.result()
            except Exception as e:              # surface on the flush point
                err = err or e
        if err is not None:
            raise err

    # -- loading ------------------------------------------------------------

    def load(self, path: str, names: Optional[Sequence[str]] = None,
             max_level=None, is_periodic=None, dtype=None,
             cache: bool = True, widen_ok: bool = False) -> AmrState:
        """Cached AmrState.from_plotfile; extends the comp set in place.

        cache=False reuses an existing entry (and the in-memory output
        registry) but never INSERTS one — the multi-file streaming loops
        (io/prefetch.iter_states) pass it so an ensemble sweep doesn't pin
        every member's device state for the session's lifetime."""
        # a previous stage's in-memory output shadows the path — but only
        # when the requested load options match what the producer built
        # (else the consumer would silently get the wrong geometry/levels/
        # precision); a mismatch falls back to the on-disk file
        if path in self.plotfiles:
            st = self.plotfiles[path]
            import jax.numpy as jnp

            from . import config
            per_ok = (is_periodic is None
                      or tuple(bool(p) for p in is_periodic)
                      == tuple(bool(p) for p in st.meta.geoms[0].is_periodic))
            lev_ok = (max_level is None
                      or max_level >= st.meta.n_levels - 1)
            # EXACT dtype match by default (r5 review fix: serving an f32
            # shadow to a dtype=float64 stage silently downgraded that
            # stage's COMPUTE precision — jnp ops follow the array dtype);
            # a mismatch falls back to the on-disk file, which reads at
            # the requested precision.  COPY-ONLY consumers (combinePlts,
            # subPlt, ... — no arithmetic) pass widen_ok=True: for them a
            # narrower shadow is value-identical to reading the wider file.
            req = jnp.zeros((), dtype or config.compute_dtype).dtype
            dt_ok = (np.dtype(req) == st.data[0].dtype
                     or (widen_ok and np.dtype(req).itemsize
                         >= st.data[0].dtype.itemsize))
            comp_ok = (names is None
                       or all(n in st.names for n in names))
            if per_ok and lev_ok and dt_ok and comp_ok:
                return st
            import os
            if not os.path.isdir(path):
                missing = ([] if comp_ok else
                           [n for n in names if n not in st.names])
                raise ValueError(
                    f"pipeline stage needs '{path}' with "
                    + (f"comps {missing}" if missing else
                       "different load options (periodicity/levels/dtype)")
                    + f", but the registered in-session output doesn't "
                    f"match and the stage that produced it ran with "
                    f"write=0 (no file on disk). Re-run the producer "
                    f"with write=1 or align the options.")
            # fall through: reload the richer on-disk file
        # settle any pending async write-back of THIS path before touching
        # the on-disk copy (r5 review fix: the pipeline driver's argv-token
        # matching missed read paths named only inside a ParmParse inputs
        # FILE; settling at the open point is input-source-agnostic)
        self.flush_writes(match=[path])
        key = _state_key(path, max_level, is_periodic, dtype)
        mtime = _header_mtime(path)
        with self._cache_lock:
            ent = self._states.get(key)
            if ent is not None and ent[0] != mtime:
                self._evict(ent[1])         # superseded by an on-disk rewrite
                del self._states[key]
                ent = None
            st = ent[1] if ent is not None else None
        if st is None:
            st = AmrState.from_plotfile(path, names=names,
                                        max_level=max_level,
                                        is_periodic=is_periodic, dtype=dtype)
            if cache:
                with self._cache_lock:
                    self._states[key] = (mtime, st)
            return st
        missing = [] if names is None else [n for n in names
                                            if n not in st.names]
        if names is None:
            vn = self._var_names.get((path, mtime))
            if vn is None:
                # parse once per (path, mtime) — this ran on EVERY warm
                # cache hit before r5
                from .io.plotfile import PlotfileReader
                vn = list(PlotfileReader(path).var_names)
                with self._cache_lock:
                    self._var_names[(path, mtime)] = vn
            missing = [n for n in vn if n not in st.names]
        if missing:
            self._extend(st, path, missing, max_level, dtype)
        return st

    def _dense_entries(self, st: AmrState):
        return [(k, v) for k, v in self._dense.items() if k[0] == id(st)]

    def _evict(self, st: AmrState) -> None:
        """Drop a state's derived caches (its _states entry is the
        caller's to remove) so the device arrays can be freed."""
        with self._cache_lock:
            for k in [k for k in self._dense if k[0] == id(st)]:
                del self._dense[k]
            self._retain.pop(id(st), None)

    def _owns(self, st: AmrState) -> bool:
        with self._cache_lock:
            return (any(ent[1] is st for ent in self._states.values())
                    or any(v is st for v in self.plotfiles.values()))

    def _extend(self, st: AmrState, path: str, missing: Sequence[str],
                max_level, dtype) -> None:
        """Read only the missing comps and append them in place — the
        DenseAmrState and its compiled-engine caches stay valid (geometry
        unchanged; engines select comps per call)."""
        import jax.numpy as jnp

        extra = AmrState.from_plotfile(path, names=list(missing),
                                       max_level=max_level, dtype=dtype)
        for lev in range(st.meta.n_levels):
            st.data[lev] = jnp.concatenate(
                [st.data[lev], extra.data[lev]], axis=1)
        st.names.extend(missing)
        for (key, ds) in self._dense_entries(st):
            dx = AmrState(st.meta, list(missing), extra.data)
            dd = DenseAmrState.from_batched(dx)
            if key[1]:
                from .parallel.dense_shard import pad_state_to
                dd = pad_state_to(dd, (key[1],) * 3)
            for lev in range(st.meta.n_levels):
                ds.data[lev] = jnp.concatenate(
                    [ds.data[lev], dd.data[lev]], axis=0)
            ds.names.extend(missing)

    def dense(self, st: AmrState, bucket: int = 0) -> DenseAmrState:
        ds = self._dense.get((id(st), bucket))
        if ds is None:
            ds = DenseAmrState.from_batched(st)
            if bucket:
                from .parallel.dense_shard import pad_state_to
                ds = pad_state_to(ds, (bucket,) * 3)
            # only pin dense caches for session-owned states — a streamed
            # multi-file load (Session.load cache=False) must not leak one
            # dense copy per ensemble member
            if self._owns(st):
                with self._cache_lock:
                    self._dense[(id(st), bucket)] = ds
                    self._retain[id(st)] = st
        return ds

    # -- artifact registry ----------------------------------------------------

    def put_plotfile(self, name: str, state) -> None:
        if isinstance(state, DenseAmrState):
            batched = state.to_batched()
        else:
            batched = state
        self.plotfiles[name] = batched

    def put_surface(self, name: str, mef) -> None:
        self.surfaces[name] = mef

    def get_surface(self, name: str):
        return self.surfaces.get(name)

    def put_lines(self, name: str, names, lines, get_elts, meta) -> None:
        """Register a stream stage's output: (var names, [nline, station,
        3+nf] array, LAZY connectivity thunk, AmrMeta) — downstream
        StreamData consumers (stream2plt, sampleStreamlines, streamSub,
        streamScatter, streamTubeStats) resolve it without a disk
        round-trip."""
        self.lines[name] = (names, lines, get_elts, meta)

    # -- driver ---------------------------------------------------------------

    def reset(self) -> None:
        self.flush_writes()
        self._reset_caches()

    def _reset_caches(self) -> None:
        """Drop every cached state and registered artifact (frees the
        device arrays).  Long-lived Python-API sessions processing many
        plotfiles should reset between files they no longer need; the
        cross-instance ENGINE caches (amr/dense.shared_engine) survive, so
        the next file still skips the re-trace."""
        with self._cache_lock:
            self._states.clear()
            self._dense.clear()
            self._retain.clear()
            self.plotfiles.clear()
            self.surfaces.clear()
            self.lines.clear()
            self._var_names.clear()

    def run(self, tool: str, **kw) -> None:
        """Run one tool with this session attached (Python-API pipeline)."""
        from .cli import main as cli_main
        argv = [tool]
        for k, v in kw.items():
            if isinstance(v, (list, tuple)):
                argv.append(f"{k}=" + " ".join(str(x) for x in v))
            else:
                argv.append(f"{k}={v}")
        # settle pending write-backs this stage might read (the CLI
        # pipeline driver and server do the same; Session.load additionally
        # settles by exact path at its open point)
        self.flush_writes(match=argv)
        rc = cli_main(argv, session=self)
        if rc != 0:
            raise RuntimeError(f"pipeline stage '{tool}' failed (rc={rc})")


# -- tool-side helpers (no-op outside a session) ------------------------------

def get_session(args: dict) -> Optional[Session]:
    s = args.get("_session")
    return s if isinstance(s, Session) else None


def load_state(args: dict, path: str, names=None, max_level=None,
               is_periodic=None, dtype=None, cache: bool = True,
               widen_ok: bool = False) -> AmrState:
    """Session-aware AmrState.from_plotfile (cache/widen_ok: see
    Session.load)."""
    s = get_session(args)
    if s is not None:
        return s.load(path, names=names, max_level=max_level,
                      is_periodic=is_periodic, dtype=dtype, cache=cache,
                      widen_ok=widen_ok)
    return AmrState.from_plotfile(path, names=names, max_level=max_level,
                                  is_periodic=is_periodic, dtype=dtype)


def dense_state(args: dict, st: AmrState) -> DenseAmrState:
    """Session-aware dense conversion.  ``shape_bucket=N`` pads every level
    extent to a multiple of N so one compiled engine serves every hierarchy
    in the bucket (pad cells are holes/edge copies — results unchanged)."""
    from .parmparse import ParmParse
    bucket = ParmParse(args).query_int("shape_bucket", 0)
    s = get_session(args)
    if s is not None:
        return s.dense(st, bucket)
    ds = DenseAmrState.from_batched(st)
    if bucket:
        from .parallel.dense_shard import pad_state_to
        ds = pad_state_to(ds, (bucket,) * 3)
    return ds


def read_stream(args: dict, path: str):
    """Session-aware StreamData read: a registered upstream stream stage
    resolves by output name; otherwise the on-disk format is parsed."""
    s = get_session(args)
    if s is not None and path in s.lines:
        import numpy as np

        from .io.stream_data import StreamData, compute_inside_nodes
        names, lines, get_elts, meta = s.lines[path]
        inside = compute_inside_nodes(meta,
                                      lines[:, lines.shape[1] // 2, :3])
        return StreamData(names, np.asarray(get_elts(), np.int32),
                          inside, lines)
    from .io.stream_data import read_stream_data
    return read_stream_data(path)


def stage_writes(args: dict) -> bool:
    """Per-stage write=0 skips disk artifacts (pipeline mode only — outside
    a session the key is ignored so single-tool runs always write)."""
    s = get_session(args)
    if s is None:
        return True
    from .parmparse import ParmParse
    return ParmParse(args).query_int("write", 1) == 1


def stage_submit_io(args: dict, path: str, thunk) -> None:
    """Run a pure-host artifact write now, or queue it on the session's
    write-back thread (async_writes) so the next stage's work overlaps it.
    The thunk must only READ its captured data (downstream in-session
    consumers share the arrays)."""
    s = get_session(args)
    if s is not None and s.async_writes:
        s.submit_write(path, thunk)
    else:
        thunk()


def stage_write_plotfile(args: dict, out, path: str) -> bool:
    """Write a tool's output plotfile honoring write= and the session's
    async write-back (Session docstring).  Returns whether a write was
    issued (sync, or queued — flushed by the pipeline/server driver)."""
    if not stage_writes(args):
        return False
    s = get_session(args)
    if s is not None and s.async_writes:
        out.to_plotfile_async(path,
                              submit=lambda th: s.submit_write(path, th))
    else:
        out.to_plotfile(path)
    return True
