"""Disaggregated input service — counterpart of ``sparkdl_tpu/inputsvc``:
a socket decode fleet and a content-addressed snapshot store.

* :class:`~sparkdl_tpu_torch.inputsvc.server.DecodeServer` — one remote
  decode worker, running the same partition task as the host
  pipeline's process pool over the length-prefixed socket transport
  (``python -m sparkdl_tpu_torch.inputsvc serve --port N``);
* :class:`~sparkdl_tpu_torch.inputsvc.client.RemotePipeline` — the
  consumer's client: fan-out, ordered re-merge with exact row identity,
  typed-transient retry and loud local-decode failover, engaged by
  :class:`~sparkdl_tpu_torch.data.engine.LocalEngine` through
  ``inputsvc_endpoints`` / ``SPARKDL_TPU_TORCH_INPUTSVC_WORKERS``;
* :func:`~sparkdl_tpu_torch.inputsvc.snapshot.snapshot_sources` — the
  store behind :meth:`DataFrame.snapshot
  <sparkdl_tpu_torch.data.frame.DataFrame.snapshot>`.

Payloads are pickle and the numpy batch codec (``data/codec.py``), not
the JAX package's cloudpickle and Arrow, so the wire and snapshot
format versions are the port's own.
"""

from sparkdl_tpu_torch.inputsvc.client import (
    ENV_ENDPOINTS,
    RemotePipeline,
    resolve_endpoints,
    state,
)
from sparkdl_tpu_torch.inputsvc.server import DecodeServer
from sparkdl_tpu_torch.inputsvc.snapshot import (
    SNAPSHOT_VERSION,
    snapshot_key,
    snapshot_sources,
)
from sparkdl_tpu_torch.inputsvc.transport import (
    WIRE_VERSION,
    TransportError,
    recv_msg,
    send_msg,
)

__all__ = [
    "ENV_ENDPOINTS",
    "SNAPSHOT_VERSION",
    "WIRE_VERSION",
    "DecodeServer",
    "RemotePipeline",
    "TransportError",
    "recv_msg",
    "resolve_endpoints",
    "send_msg",
    "snapshot_key",
    "snapshot_sources",
    "state",
]
