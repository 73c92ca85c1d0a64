"""The decode-fleet worker: a socket server running partition decode —
counterpart of ``sparkdl_tpu/inputsvc/server.py``.

One :class:`DecodeServer` is one remote decode worker. It accepts framed
requests (``inputsvc/transport.py``) and runs each partition through the
same task the host pipeline's process pool runs
(:func:`~sparkdl_tpu_torch.data.pipeline._pooled_partition_task`: source
load, the host-stage prefix, its fault sites and busy-second
accounting) with shared memory off, since a socket peer cannot attach
this process's segments.

Ops:

* ``ping`` — liveness: replies ``{ok, pid, version}``. The client pings
  each endpoint at stream start and drops unreachable ones loudly.
* ``decode`` — the header carries ``token`` (the plan-cache key),
  ``index`` and ``plan_len``; the payload is the pickled plan followed
  by the pickled source. The reply header carries ``kind``: ``"buf"``
  with ``busy``, ``timings`` and ``rows``, the payload being the
  fragment in the numpy batch codec; or ``"err"`` with ``repr`` and
  ``type``, the payload the pickled exception (empty when it does not
  pickle).

A failure that can still be reported replies ``{ok: False, error}``;
one that cannot (a broken socket) drops the connection. Either way the
client owns recovery (retry through the engine's policy, then local
decode), so a dying worker never loses or duplicates a row. Counted:
``inputsvc.server_requests`` and ``inputsvc.server_errors``.

The server runs the plans it is sent, and unpickling runs code: bind it
only where its clients are trusted. It binds ``127.0.0.1`` by default.
``python -m sparkdl_tpu_torch.inputsvc serve --port N`` runs one in the
foreground (``__main__.py``).
"""

from __future__ import annotations

import logging
import os
import socket
import threading
from typing import Optional

from sparkdl_tpu_torch.inputsvc import transport
from sparkdl_tpu_torch.obs import default_registry

logger = logging.getLogger(__name__)

#: shared-memory floor passed to the pooled task: never reached, so every
#: fragment comes back in the result tuple
_NO_SHM = 1 << 62


def _count(what: str, amount: float = 1.0) -> None:
    default_registry().counter(f"inputsvc.{what}").add(amount)


class DecodeServer:
    """One decode-fleet worker (module docstring). A thread per
    connection: a client holds one connection per endpoint per stream,
    and the pooled task is thread-safe."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self._sock = socket.create_server((host, port))
        self.port = self._sock.getsockname()[1]
        self._lock = threading.Lock()
        self._conns: list = []
        self._closed = False
        self._accept_thread: Optional[threading.Thread] = None

    # a live listener does not ship: refuse loudly
    def __getstate__(self):
        raise TypeError("DecodeServer holds live sockets and cannot "
                        "be pickled; ship its host:port endpoint "
                        "instead")

    def start(self) -> "DecodeServer":
        """Serve in a background thread (tests, in-process fleets);
        returns self so ``DecodeServer(port=0).start()`` composes."""
        t = threading.Thread(target=self.serve_forever,
                             name=f"inputsvc-accept:{self.port}",
                             daemon=True)
        self._accept_thread = t
        t.start()
        return self

    def serve_forever(self) -> None:
        """Accept connections until :meth:`close`."""
        while True:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return          # the listener closed: the clean exit
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.append(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn, addr),
                name=f"inputsvc-conn:{addr[1]}", daemon=True).start()

    def _serve_conn(self, conn: socket.socket, addr) -> None:
        try:
            while True:
                try:
                    header, payload = transport.recv_msg(conn)
                except transport.TransportError as e:
                    # a client hang-up lands here too
                    logger.debug("inputsvc server: connection %s "
                                 "ended: %s", addr, e)
                    return
                try:
                    self._dispatch(conn, header, payload)
                except transport.TransportError:
                    return
        finally:
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            conn.close()

    def _dispatch(self, conn: socket.socket, header: dict,
                  payload: bytearray) -> None:
        _count("server_requests")
        op = header.get("op")
        try:
            if op == "ping":
                transport.send_msg(conn, {
                    "ok": True, "pid": os.getpid(),
                    "version": transport.WIRE_VERSION})
            elif op == "decode":
                self._handle_decode(conn, header, payload)
            else:
                _count("server_errors")
                transport.send_msg(conn, {"ok": False,
                                          "error": f"unknown op {op!r}"})
        except transport.TransportError:
            # the reply could not be sent; the client sees the dead
            # socket as a transient and retries or fails over
            _count("server_errors")
            logger.warning("inputsvc server: reply to %r failed; "
                           "dropping connection", op)
            raise

    def _handle_decode(self, conn: socket.socket, header: dict,
                       payload: bytearray) -> None:
        from sparkdl_tpu_torch.data.pipeline import _pooled_partition_task
        token = str(header.get("token", ""))
        index = int(header.get("index", 0))
        plan_len = int(header.get("plan_len", 0))
        if not 0 <= plan_len <= len(payload):
            _count("server_errors")
            transport.send_msg(conn, {
                "ok": False,
                "error": f"plan_len {plan_len} out of range for a "
                         f"{len(payload)}-byte payload"})
            return
        view = memoryview(payload)
        # the pooled task never raises: a failure comes back as a typed
        # ("err", ...) tuple
        result = _pooled_partition_task(token, view[:plan_len],
                                        view[plan_len:], index, _NO_SHM)
        if result[0] == "buf":
            _, data, busy, timings, rows = result
            transport.send_msg(conn, {"ok": True, "kind": "buf",
                                      "busy": busy, "timings": timings,
                                      "rows": rows}, data)
        else:
            _, blob, rep, type_name = result
            transport.send_msg(conn, {"ok": True, "kind": "err",
                                      "repr": rep, "type": type_name},
                               blob or b"")

    def close(self) -> None:
        """Stop accepting and drop live connections (in-flight replies
        abort; the client's retry and failover own recovery)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
        try:
            # close() alone does not wake a thread parked in accept()
            # on Linux; shutdown() does
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError as e:
            logger.debug("inputsvc server: listener shutdown failed: %s",
                         e)
        self._sock.close()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
                conn.close()
            except OSError as e:
                logger.debug("inputsvc server: closing a connection "
                             "failed: %s", e)
        t = self._accept_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
