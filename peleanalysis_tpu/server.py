"""Persistent tool server: one process, one Session, warm jit caches.

A reference tool is an AOT-compiled binary — per-invocation cost is ~zero
(/root/reference/Src/GNUmakefile:14-40, one executable per analysis).  A
Python CLI pays interpreter start + jax import + plotfile parse + trace-cache
lookup on EVERY invocation.  ``python -m peleanalysis_tpu serve``
matches the AOT model with one resident process that keeps the XLA
client, the compiled engines, and a shared :class:`Session` (cached plotfile
loads, device states, registered outputs) across commands.

Protocol (newline-delimited JSON over a unix socket):

  request   {"argv": ["grad", "infile=plt", ...]}     run one CLI command
            {"argv": [...], "sync": true}              ... and settle the
                                                       command's write-backs
                                                       before replying
            {"cmd": "ping"}                            liveness probe
            {"cmd": "flush"}                           settle ALL pending
                                                       write-backs
            {"cmd": "reset"}                           drop the Session
            {"cmd": "shutdown"}                        reply, then exit
  reply     {"rc": int, "out": str, "err": str}

Write-back semantics: plotfile/line/surface writes are ASYNC by default —
a command's reply can arrive while its output file is still being written
(the write overlaps the next command's device work; a later command whose
argv names the path settles it first).  An external reader that needs the
file on reply must send ``sync: true`` (the ``send`` CLI client does) or
``flush``.

Commands run through the SAME code path as the one-shot CLI (cli.main with
a session), so ParmParse keys, pipeline stages, and outputs are identical —
test-pinned byte-for-byte in tests/test_server.py.  Commands execute
sequentially (one device context); a long-lived server can bound memory
with the ``reset`` command (drops cached states, keeps compiled engines).

Clients: any language can speak the protocol; ``send_command()`` below is
the Python helper, and ``python -m peleanalysis_tpu send socket=S <tool>
k=v ...`` is the CLI client."""
from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import sys


DEFAULT_SOCKET = "pele_serve.sock"


def _recv_lines(conn):
    buf = b""
    while True:
        try:
            chunk = conn.recv(1 << 16)
        except socket.timeout:
            # a stalled/crashed client (connected but never completing a
            # request line) must not wedge the single-threaded accept loop:
            # drop the connection and serve the next client.  Clients open
            # one connection per command (send_command), so a legitimate
            # peer is never idle this long mid-request.
            return
        if not chunk:
            return
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                yield line


def serve(args: dict) -> int:
    """CLI: serve [socket=pele_serve.sock] [verbose=0] [max_requests=N]
    [idle_timeout=120 — seconds before an idle/stalled CONNECTION is
    dropped (commands themselves are unbounded); 0 disables]"""
    from .parmparse import ParmParse
    from .session import Session

    pp = ParmParse(args)
    path = pp.query_str("socket", DEFAULT_SOCKET)
    verbose = pp.query_bool("verbose", False)
    max_requests = pp.query_int("max_requests", 0)   # 0 = unlimited (tests)
    idle_timeout = pp.query_float("idle_timeout", 120.0)
    if os.path.exists(path):
        os.unlink(path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(8)
    # async write-back: a command's plotfile writes overlap the NEXT
    # command's device work; any command whose argv mentions a pending
    # output path flushes it first, and reset/shutdown flush everything
    # (write errors surface on the flushing command's reply)
    sess = Session(async_writes=True)
    print(f"serving on {path}", flush=True)
    n_req = 0
    try:
        while True:
            conn, _ = srv.accept()
            try:
                rc_done, n_req = _serve_conn(conn, sess, idle_timeout,
                                             verbose, max_requests, n_req)
            except (BrokenPipeError, ConnectionResetError, OSError) as e:
                # a client that vanished mid-request (its send_command
                # timeout fired, it was killed, ...) must not take the
                # server's warm Session/engines with it (r5 review fix:
                # reply writes raised outside any try and escaped the
                # accept loop)
                print(f"server: client connection dropped ({e}); "
                      "keeping engines warm", flush=True)
                continue
            if rc_done is not None:
                return rc_done
    finally:
        with contextlib.suppress(Exception):
            sess.flush_writes()
        srv.close()
        with contextlib.suppress(OSError):
            os.unlink(path)


def _serve_conn(conn, sess, idle_timeout, verbose, max_requests, n_req):
    """Handle one client connection.  Returns (rc, n_req): rc is an exit
    code to stop the server (shutdown / max_requests reached) or None to
    keep accepting; n_req is the updated cross-connection request count."""
    with conn:
        if idle_timeout:
            conn.settimeout(idle_timeout)
        f = conn.makefile("wb")

        def reply(rep):
            f.write(json.dumps(rep).encode() + b"\n")
            f.flush()

        for line in _recv_lines(conn):
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                reply({"rc": 2, "out": "", "err": f"bad json: {e}"})
                continue
            cmd = req.get("cmd")
            if cmd == "shutdown":
                try:
                    sess.flush_writes()
                    rep = {"rc": 0, "out": "bye", "err": ""}
                except Exception as e:
                    rep = {"rc": 1, "out": "",
                           "err": f"pending write failed: {e}"}
                reply(rep)
                return 0, n_req
            if cmd == "ping":
                reply({"rc": 0, "out": "pong", "err": ""})
                continue
            if cmd == "flush":
                try:
                    sess.flush_writes()
                    rep = {"rc": 0, "out": "flushed", "err": ""}
                except Exception as e:
                    rep = {"rc": 1, "out": "",
                           "err": f"pending write failed: {e}"}
                reply(rep)
                continue
            if cmd == "reset":
                try:
                    sess.reset()   # flushes pending writes first
                    rep = {"rc": 0, "out": "reset", "err": ""}
                except Exception as e:
                    rep = {"rc": 1, "out": "",
                           "err": f"pending write failed: {e}"}
                reply(rep)
                continue
            if cmd is not None:
                # r5 review fix: a typo'd cmd fell through to cli_main([])
                reply({"rc": 2, "out": "", "err": f"unknown cmd: {cmd}"})
                continue
            argv = req.get("argv") or []
            if verbose:
                print(f"<- {' '.join(argv)}", flush=True)
            out, err = io.StringIO(), io.StringIO()
            try:
                from .cli import main as cli_main
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(err):
                    # settle pending write-backs this command might
                    # read from disk (paths named in its argv)
                    sess.flush_writes(match=argv)
                    rc = cli_main(argv, session=sess)
            except SystemExit as e:
                # tools should return, but be robust to sys.exit — incl.
                # sys.exit("message"), whose code is a str (r5 review fix:
                # int(str) raised out of this handler and killed the loop)
                code = e.code
                if isinstance(code, int) or code is None:
                    rc = code or 0
                else:
                    rc = 1
                    err.write(str(code))
            except Exception as e:        # keep the server alive:
                import traceback          # one bad command must not
                rc = 1                    # kill warm engine caches
                err.write(traceback.format_exc())
                err.write(f"\n{type(e).__name__}: {e}")
            if req.get("sync") and rc == 0:
                # external caller wants the files on reply: settle
                # every pending write-back (a write failure is THIS
                # command's failure from the caller's view)
                try:
                    sess.flush_writes()
                except Exception as e:
                    rc = 1
                    err.write(f"pending write failed: {e}")
            reply({"rc": rc, "out": out.getvalue(),
                   "err": err.getvalue()})
            n_req += 1
            if max_requests and n_req >= max_requests:
                return 0, n_req
    return None, n_req


def send_command(path: str, argv=None, cmd=None, timeout=600.0,
                 sync=False):
    """One request over the socket; returns the reply dict.
    sync=True makes the server settle the command's async write-backs
    before replying (files exist when this returns); the default keeps
    writes overlapped with the next command's work."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(timeout)
    c.connect(path)
    try:
        if argv is not None:
            req = {"argv": list(argv)}
            if sync:
                req["sync"] = True
        else:
            req = {"cmd": cmd}
        c.sendall(json.dumps(req).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            chunk = c.recv(1 << 16)
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
        return json.loads(buf.split(b"\n", 1)[0])
    finally:
        c.close()


def send(args: dict, argv_rest) -> int:
    """CLI client: send [socket=pele_serve.sock] [sync=1] <tool> key=value...
    Prints the server's stdout/stderr and propagates its return code.
    sync defaults ON: a shell pipeline (`send ... && cat out`) must see the
    output files when the command returns; pass sync=0 to let the write
    overlap the next command (pipeline-style drivers)."""
    from .parmparse import ParmParse

    pp = ParmParse(args)
    path = pp.query_str("socket", DEFAULT_SOCKET)
    sync = pp.query_bool("sync", True)
    if not argv_rest:
        print("send: missing command (usage: send [socket=S] <tool> k=v...)")
        return 2
    rep = send_command(path, argv=argv_rest, sync=sync)
    if rep.get("out"):
        sys.stdout.write(rep["out"])
    if rep.get("err"):
        sys.stderr.write(rep["err"])
    return int(rep.get("rc", 1))
