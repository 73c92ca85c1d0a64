"""The consumer side of the decode fleet: fan-out and ordered re-merge
over the socket transport — counterpart of
``sparkdl_tpu/inputsvc/client.py``.

:class:`RemotePipeline` is the client of one or more
:class:`~sparkdl_tpu_torch.inputsvc.server.DecodeServer` workers
(``SPARKDL_TPU_TORCH_INPUTSVC_WORKERS="host:port,host:port"`` or the
engine's ``inputsvc_endpoints``). Per stream it:

* pings every configured endpoint and drops unreachable ones loudly
  (``inputsvc.endpoints_down`` and one warning); with none left it
  returns None and :class:`~sparkdl_tpu_torch.data.engine.LocalEngine`
  takes its local path, counted in ``inputsvc.fallbacks``;
* fans partitions out round-robin across the live endpoints and
  re-merges fragments in partition order within the engine's live
  ``pipeline_read_ahead`` window — row identity and order are exact;
* treats every wire failure as a typed transient
  (:class:`~sparkdl_tpu_torch.inputsvc.transport.TransportError`, and
  the ``inputsvc.rpc`` fault site) and re-runs the partition through the
  engine's shared retry policy; a partition whose retries run out, or
  whose last endpoint died, is decoded locally
  (``inputsvc.local_decodes`` and one warning), so a killed worker costs
  time, never a row;
* folds each fragment's decode seconds into ``engine.busy_seconds``.

Connections are per stream, so an engine pickles without a socket.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from sparkdl_tpu_torch.data.codec import Batch
from sparkdl_tpu_torch.data.engine import _num_rows, _quiesce
from sparkdl_tpu_torch.data.pipeline import (
    _consume_result,
    _warn_once,
    pickle_payload,
    record_worker_time,
)
from sparkdl_tpu_torch.inputsvc import transport
from sparkdl_tpu_torch.obs import default_registry
from sparkdl_tpu_torch.resilience.errors import TransientError
from sparkdl_tpu_torch.resilience.faults import maybe_fail

logger = logging.getLogger(__name__)

#: the fleet env knob: comma-separated ``host:port`` endpoints. Unset =
#: no remote decode; a malformed spec degrades to none with one warning
#: and ``inputsvc.config_errors``
ENV_ENDPOINTS = "SPARKDL_TPU_TORCH_INPUTSVC_WORKERS"

#: connect and handshake timeout per endpoint: an unreachable worker
#: costs seconds at stream start, not a hung stream
CONNECT_TIMEOUT_S = 5.0

#: per-RPC reply timeout: a wedged worker surfaces as a typed transient
DEFAULT_RPC_TIMEOUT_S = 120.0


def _count(what: str, amount: float = 1.0) -> None:
    default_registry().counter(f"inputsvc.{what}").add(amount)


def resolve_endpoints(explicit=None) -> List[Tuple[str, int]]:
    """The configured fleet: an explicit value (comma string or list of
    ``host:port``) wins, then :data:`ENV_ENDPOINTS`. Any malformed
    entry degrades the whole spec to no fleet with one warning and
    ``inputsvc.config_errors``: a partial fleet would be a different
    deployment than the one configured."""
    if explicit is None:
        raw = os.environ.get(ENV_ENDPOINTS, "")
    elif isinstance(explicit, str):
        raw = explicit
    else:
        raw = ",".join(str(e) for e in explicit)
    raw = raw.strip()
    if not raw:
        return []
    out: List[Tuple[str, int]] = []
    for entry in raw.split(","):
        if not entry.strip():
            continue
        ep = transport.parse_endpoint(entry)
        if ep is None:
            logger.warning(
                "%s entry %r is not host:port; remote decode disabled "
                "(fix the full spec — a partial fleet would be a "
                "different deployment than configured)",
                ENV_ENDPOINTS if explicit is None else
                "inputsvc_endpoints", entry)
            _count("config_errors")
            return []
        out.append(ep)
    return out


_last_state: Dict[str, Any] = {}
_state_lock = threading.Lock()
_active = [0]                      # streams running now


def _record_state(**kv) -> None:
    with _state_lock:
        _last_state.update(kv)


def state() -> Dict[str, Any]:
    """The input service's state as a plain dict: the last stream's
    fleet, the live stream count, and the ``inputsvc.*`` counters (the
    snapshot store's share the prefix)."""
    snap = default_registry().snapshot()
    with _state_lock:
        out = dict(_last_state)
        out["streams_active"] = _active[0]
    out["counters"] = {k: v for k, v in snap.items()
                       if k.startswith("inputsvc.")}
    return out


class _FleetUnavailable(TransientError):
    """No live endpoint remains for this RPC — transient (a retry may
    find one), and past the retries the local decode owns it."""


class _Endpoint:
    """One connected decode worker: a socket and the lock serialising
    RPCs on it (one request in flight per connection; parallelism comes
    from the fleet's width)."""

    def __init__(self, host: str, port: int,
                 rpc_timeout_s: float = DEFAULT_RPC_TIMEOUT_S):
        self.host = host
        self.port = port
        self.rpc_timeout_s = rpc_timeout_s
        self.sock: Optional[socket.socket] = None
        self.alive = False
        self._lock = threading.Lock()

    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        state["sock"] = None
        state["alive"] = False
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def connect(self) -> bool:
        """Dial and ping; False (never raises) on an unreachable,
        refusing or mis-speaking peer."""
        sock = None
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=CONNECT_TIMEOUT_S)
            transport.send_msg(sock, {"op": "ping"})
            header, _ = transport.recv_msg(sock)
            if not header.get("ok"):
                raise transport.TransportError(
                    f"ping rejected: {header!r}")
            sock.settimeout(self.rpc_timeout_s)
        except (OSError, transport.TransportError) as e:
            logger.debug("inputsvc: endpoint %s:%d unreachable: %s",
                         self.host, self.port, e)
            if sock is not None:
                sock.close()
            return False
        with self._lock:
            self.sock = sock
            self.alive = True
        return True

    def rpc_decode(self, token: str, plan_blob: bytes, src_blob: bytes,
                   index: int) -> tuple:
        """One partition's remote decode → the pooled task's result
        tuple. A wire failure marks this endpoint dead and raises a
        typed transient."""
        with self._lock:
            sock = self.sock
            if not self.alive or sock is None:
                raise _FleetUnavailable(
                    f"endpoint {self.host}:{self.port} is down")
            try:
                transport.send_msg(
                    sock, {"op": "decode", "token": token, "index": index,
                           "plan_len": len(plan_blob)},
                    plan_blob + src_blob)
                # one socket is one serial request/response channel
                header, payload = transport.recv_msg(sock)
            except (OSError, transport.TransportError) as e:
                self._mark_dead_locked()
                _count("rpc_errors")
                if isinstance(e, transport.TransportError):
                    raise
                raise transport.TransportError(
                    f"decode RPC to {self.host}:{self.port} "
                    f"failed: {e}") from e
        if not header.get("ok"):
            _count("rpc_errors")
            raise transport.TransportError(
                f"endpoint {self.host}:{self.port} rejected the "
                f"decode RPC: {header.get('error')!r}")
        _count("bytes", len(payload))
        if header.get("kind") == "err":
            return ("err", bytes(payload) or None, header.get("repr"),
                    header.get("type"))
        return ("buf", payload, float(header["busy"]),
                [tuple(t) for t in header["timings"]], int(header["rows"]))

    def _mark_dead_locked(self) -> None:
        # the caller holds self._lock
        sock, self.sock = self.sock, None
        self.alive = False
        if sock is not None:
            try:
                sock.close()
            except OSError as e:
                logger.debug("inputsvc: closing a dead endpoint socket "
                             "failed: %s", e)

    def close(self) -> None:
        with self._lock:
            self._mark_dead_locked()

    def is_alive(self) -> bool:
        with self._lock:
            return self.alive


class RemotePipeline:
    """Fan partitions out to the decode fleet and re-merge fragments in
    order (module docstring). One instance per stream."""

    def __init__(self, endpoints: Sequence[Tuple[str, int]],
                 rpc_timeout_s: float = DEFAULT_RPC_TIMEOUT_S):
        self.endpoints = [_Endpoint(h, p, rpc_timeout_s)
                          for h, p in endpoints]

    def _connect_fleet(self) -> List[_Endpoint]:
        live: List[_Endpoint] = []
        for ep in self.endpoints:
            if ep.connect():
                live.append(ep)
            else:
                _count("endpoints_down")
                _warn_once(
                    f"down:{ep.host}:{ep.port}",
                    "inputsvc: decode worker %s:%d is unreachable; "
                    "streaming on the remaining fleet (local decode "
                    "if none remains)", ep.host, ep.port)
        return live

    def stream(self, sources: Sequence, plan: Sequence, engine
               ) -> Optional[Iterator[Tuple[int, Batch]]]:
        """Yield ``(logical_index, fragment)`` in partition order via
        the fleet, or None when no remote stream can run (nothing
        pickles, or no endpoint answered)."""
        plan = list(plan)
        payload = pickle_payload(sources, plan, "inputsvc",
                                 "decoding locally")
        if payload is None:
            return None
        live = self._connect_fleet()
        _record_state(
            endpoints=[f"{ep.host}:{ep.port}" for ep in self.endpoints],
            live_endpoints=[f"{ep.host}:{ep.port}" for ep in live])
        if not live:
            _count("fallbacks")
            _warn_once("fleet-empty",
                       "inputsvc: no configured decode worker is "
                       "reachable; falling back to local decode (the "
                       "fleet is configured but absent)")
            return None
        plan_blob, src_blobs = payload
        return self._merge(sources, plan, engine, live, plan_blob,
                           src_blobs, uuid.uuid4().hex)

    def _merge(self, sources, plan, engine, live, plan_blob, src_blobs,
               token):
        drain = (any(getattr(st, "effectful", False) for st in plan)
                 or any(getattr(src, "effectful", False)
                        for src in sources))
        rr_lock = threading.Lock()
        rr = [0]

        def _logical(pos: int) -> int:
            logical = getattr(sources[pos], "logical_index", None)
            return pos if logical is None else logical

        def _pick() -> _Endpoint:
            with rr_lock:
                rr[0] += 1
                start = rr[0]
            for i in range(len(live)):
                ep = live[(start + i) % len(live)]
                if ep.is_alive():
                    return ep
            raise _FleetUnavailable(
                "every connected decode worker died mid-stream")

        def _fetch(pos: int) -> Batch:
            logical = _logical(pos)

            def once() -> Batch:
                # the fragment-RPC fault site
                maybe_fail("inputsvc.rpc")
                result = _pick().rpc_decode(token, plan_blob,
                                            src_blobs[pos], logical)
                batch, busy, timings = _consume_result(result)
                record_worker_time(busy, timings)
                return batch

            try:
                return engine.retry_policy.call(
                    once, key=f"inputsvc:{logical}",
                    on_retry=engine._log_retry(
                        f"remote partition {logical}"))
            except TransientError as exc:
                # retries exhausted or the whole fleet died: decode this
                # partition locally. Permanent errors propagate typed (a
                # decode that fails on bad data fails locally too).
                _count("local_decodes")
                _warn_once("local-failover",
                           "inputsvc: remote decode failed past the "
                           "retry budget (%s); failing over to local "
                           "decode for affected partitions",
                           type(exc).__name__)
                return engine._run_partition(sources[pos], plan, pos)

        def _gen():
            with _state_lock:
                _active[0] += 1
            default_registry().gauge("inputsvc.workers").set(len(live))
            pool = ThreadPoolExecutor(
                max_workers=len(live),
                thread_name_prefix="sparkdl-torch-inputsvc")
            pending: Dict[int, Future] = {}
            next_to_submit = 0
            next_to_yield = 0
            n = len(sources)
            try:
                while next_to_yield < n:
                    window = max(len(live), int(getattr(
                        engine, "pipeline_read_ahead", 0) or 1))
                    while next_to_submit < n and len(pending) < window:
                        pending[next_to_submit] = pool.submit(
                            _fetch, next_to_submit)
                        next_to_submit += 1
                    pos = next_to_yield
                    batch = pending.pop(pos).result()
                    _count("tasks")
                    _count("rows", _num_rows(batch))
                    yield _logical(pos), batch
                    next_to_yield += 1
            finally:
                for fut in pending.values():
                    fut.cancel()
                if drain:
                    _quiesce(pending.values())
                pool.shutdown(wait=False, cancel_futures=True)
                for ep in live:
                    ep.close()
                with _state_lock:
                    _active[0] -= 1
                    if not _active[0]:
                        default_registry().gauge("inputsvc.workers").set(0)

        return _gen()
