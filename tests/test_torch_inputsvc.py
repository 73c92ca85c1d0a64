"""The port's input service (``sparkdl_tpu_torch/inputsvc``) against the
JAX package's on the CPU: the socket framing and its refusals, endpoint
resolution case for case, remote decode through one and two in-process
``DecodeServer``s equal row for row to the JAX package's own fleet on
the same inputs, the loud local fallbacks (an unreachable fleet, a
worker killed mid-stream, an RPC fault drill), the snapshot store's
cold and warm epochs and its invalidation cases, and the
``python -m sparkdl_tpu_torch.inputsvc serve`` CLI. Rows and bytes are
compared exactly. Counters are process-wide: every check reads a
difference of two snapshots. Every wait is bounded."""

import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 100
N_PARTS = 8
WAIT_S = 60.0


#: every test here ends within this: a hung pool, worker or server fails
#: its test (SIGALRM interrupts the wait) instead of stalling the run
TEST_LIMIT_S = 120


@pytest.fixture(autouse=True)
def _bounded():
    def fail(signum, frame):
        raise TimeoutError(f"test ran past {TEST_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _port_double(batch):
    return {**batch, "x": batch["x"] * 2.0}


def _columns(n=N_ROWS):
    return {"id": np.arange(n, dtype=np.int64),
            "x": np.arange(n, dtype=np.float64)}


def _port_collect(engine, n=N_ROWS, parts=N_PARTS):
    from sparkdl_tpu_torch.data.frame import DataFrame
    df = DataFrame.from_columns(_columns(n), parts, engine)
    return df.map_batches(_port_double, name="double").collect()


def _jax_collect(engine, n=N_ROWS, parts=N_PARTS):
    import pyarrow as pa
    import pyarrow.compute as pc
    from sparkdl_tpu.data.frame import DataFrame

    def double(batch):
        i = batch.schema.get_field_index("x")
        return batch.set_column(i, "x", pc.multiply(batch.column("x"), 2.0))

    table = pa.table({k: pa.array(v) for k, v in _columns(n).items()})
    out = DataFrame.from_table(table, parts, engine).map_batches(
        double, name="double").collect()
    return {name: out.column(name).to_numpy() for name in out.column_names}


def _assert_same(got, want):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert got[name].tobytes() == want[name].tobytes()


def _delta(before, name):
    from sparkdl_tpu_torch.obs import default_registry
    return default_registry().snapshot().get(name, 0.0) - \
        before.get(name, 0.0)


def _snap():
    from sparkdl_tpu_torch.obs import default_registry
    return default_registry().snapshot()


@pytest.fixture(autouse=True)
def _disarmed():
    from sparkdl_tpu_torch.resilience import faults
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def local_result():
    """The serial engine's rows: what every other path must give."""
    from sparkdl_tpu_torch.data.engine import LocalEngine
    engine = LocalEngine()
    try:
        got = _port_collect(engine)
    finally:
        engine.shutdown()
    from sparkdl_tpu.data.engine import LocalEngine as JaxEngine
    ref_engine = JaxEngine()
    try:
        _assert_same(got, _jax_collect(ref_engine))
    finally:
        ref_engine.shutdown()
    return got


@pytest.fixture
def server():
    from sparkdl_tpu_torch.inputsvc import DecodeServer
    srv = DecodeServer().start()
    yield srv
    srv.close()


def _engine(endpoints):
    from sparkdl_tpu_torch.data.engine import LocalEngine
    return LocalEngine(inputsvc_endpoints=endpoints)


# -- transport -------------------------------------------------------------

def _pair():
    a, b = socket.socketpair()
    a.settimeout(WAIT_S)
    b.settimeout(WAIT_S)
    return a, b


def test_transport_round_trip_and_empty_payload():
    from sparkdl_tpu_torch.inputsvc import recv_msg, send_msg
    a, b = _pair()
    with a, b:
        send_msg(a, {"op": "decode", "index": 3}, b"\x00payload\xff" * 50)
        header, payload = recv_msg(b)
        assert header == {"op": "decode", "index": 3}
        assert bytes(payload) == b"\x00payload\xff" * 50
        assert isinstance(payload, bytearray)
        send_msg(a, {"op": "ping"})
        header, payload = recv_msg(b)
        assert header == {"op": "ping"} and payload == b""


def test_transport_refuses_bad_magic_oversize_and_truncation():
    import struct
    from sparkdl_tpu_torch.inputsvc import TransportError, recv_msg, send_msg
    from sparkdl_tpu_torch.inputsvc import transport
    from sparkdl_tpu_torch.resilience.errors import is_transient
    a, b = _pair()
    with a, b:
        a.sendall(b"JUNK" + bytes(14))
        with pytest.raises(TransportError, match="magic"):
            recv_msg(b)
    a, b = _pair()
    with a, b:
        a.sendall(struct.pack(">4sHIQ", transport.MAGIC,
                              transport.WIRE_VERSION,
                              transport.MAX_HEADER_BYTES + 1, 0))
        with pytest.raises(TransportError, match="header length"):
            recv_msg(b)
    a, b = _pair()
    with a, b:
        with pytest.raises(TransportError, match="header of"):
            send_msg(a, {"pad": "x" * (transport.MAX_HEADER_BYTES + 1)})
    a, b = _pair()
    with b:
        send_msg(a, {"op": "decode"}, b"12345678")
        # cut the frame short: the peer hangs up mid-payload
        raw = b.recv(transport._PREFIX.size + 15)
        c, d = _pair()
        with c, d:
            c.sendall(raw[:-3])
            c.close()
            with pytest.raises(TransportError, match="short"):
                recv_msg(d)
        a.close()
    assert is_transient(TransportError("x"))


def test_port_and_jax_refuse_each_others_wire():
    """The same layout with different payloads: a JAX peer and a port
    peer fail the version check instead of misreading each other."""
    from sparkdl_tpu.inputsvc import transport as jax_transport
    from sparkdl_tpu_torch.inputsvc import transport
    assert transport.MAGIC == jax_transport.MAGIC
    assert transport.WIRE_VERSION != jax_transport.WIRE_VERSION
    a, b = _pair()
    with a, b:
        jax_transport.send_msg(a, {"op": "ping"})
        with pytest.raises(transport.TransportError, match="version"):
            transport.recv_msg(b)
    a, b = _pair()
    with a, b:
        transport.send_msg(a, {"op": "ping"})
        with pytest.raises(jax_transport.TransportError, match="version"):
            jax_transport.recv_msg(b)


@pytest.mark.parametrize("raw", [
    "127.0.0.1:8080", " host:1 ", "h:0", "h:65536", "h:x", ":80", "h80",
    "[::1]:9", "a:b:7", ""])
def test_parse_endpoint_matches_jax(raw):
    from sparkdl_tpu.inputsvc.transport import parse_endpoint as jax_parse
    from sparkdl_tpu_torch.inputsvc.transport import parse_endpoint
    assert parse_endpoint(raw) == jax_parse(raw)


@pytest.mark.parametrize("explicit,env", [
    (None, None), (None, ""), (None, "127.0.0.1:9001,127.0.0.1:9002"),
    (None, "127.0.0.1:9001,bogus"), ("h:1", "127.0.0.1:9"),
    (["h:1", "g:2"], None), ("h:1,,g:2", None), ("nope", None),
    ([], "h:5")])
def test_resolve_endpoints_matches_jax(monkeypatch, explicit, env):
    from sparkdl_tpu.inputsvc import client as jax_client
    from sparkdl_tpu.obs import default_registry as jax_registry
    from sparkdl_tpu_torch.inputsvc import client
    for name in (jax_client.ENV_ENDPOINTS, client.ENV_ENDPOINTS):
        if env is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, env)
    before, jbefore = _snap(), jax_registry().snapshot()
    assert client.resolve_endpoints(explicit) == \
        jax_client.resolve_endpoints(explicit)
    assert _delta(before, "inputsvc.config_errors") == \
        jax_registry().snapshot().get("inputsvc.config_errors", 0.0) - \
        jbefore.get("inputsvc.config_errors", 0.0)


# -- remote decode -----------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2])
def test_fleet_matches_jax_fleet(local_result, width):
    """The same frame through ``width`` in-process servers of each
    package: the port's rows equal the serial run's and the JAX fleet's,
    byte for byte; the port counts its tasks, rows and no fallback."""
    from sparkdl_tpu.data.engine import LocalEngine as JaxEngine
    from sparkdl_tpu.inputsvc import DecodeServer as JaxServer
    from sparkdl_tpu_torch.inputsvc import DecodeServer
    servers = [DecodeServer().start() for _ in range(width)]
    jax_servers = [JaxServer().start() for _ in range(width)]
    engine = _engine([f"127.0.0.1:{s.port}" for s in servers])
    ref_engine = JaxEngine(inputsvc_endpoints=[
        f"127.0.0.1:{s.port}" for s in jax_servers])
    before = _snap()
    try:
        got = _port_collect(engine)
        ref = _jax_collect(ref_engine)
    finally:
        engine.shutdown()
        ref_engine.shutdown()
        for s in servers + jax_servers:
            s.close()
    _assert_same(got, local_result)
    _assert_same(got, ref)
    assert _delta(before, "inputsvc.tasks") == N_PARTS
    assert _delta(before, "inputsvc.rows") == N_ROWS
    assert _delta(before, "inputsvc.server_requests") >= N_PARTS + width
    for name in ("inputsvc.fallbacks", "inputsvc.local_decodes",
                 "inputsvc.rpc_errors"):
        assert _delta(before, name) == 0


def test_unreachable_fleet_falls_back_loudly(local_result, caplog):
    sock = socket.create_server(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()                       # nothing listens there now
    engine = _engine(f"127.0.0.1:{port}")
    before = _snap()
    try:
        with caplog.at_level("WARNING",
                             logger="sparkdl_tpu_torch.inputsvc.client"):
            got = _port_collect(engine)
    finally:
        engine.shutdown()
    _assert_same(got, local_result)
    assert _delta(before, "inputsvc.fallbacks") == 1
    assert _delta(before, "inputsvc.endpoints_down") == 1


def test_killed_worker_fails_over_per_partition(local_result):
    """A worker that dies after two fragments, mid-stream: every
    partition still lands once, the rest through the local failover."""
    from sparkdl_tpu_torch.inputsvc import DecodeServer

    class Dying(DecodeServer):
        served = 0

        def _handle_decode(self, conn, header, payload):
            if Dying.served == 2:
                self.close()           # dies with a request in hand
                return
            Dying.served += 1
            super()._handle_decode(conn, header, payload)

    srv = Dying().start()
    engine = _engine(f"127.0.0.1:{srv.port}")
    before = _snap()
    try:
        got = _port_collect(engine)
    finally:
        engine.shutdown()
        srv.close()
    _assert_same(got, local_result)
    assert _delta(before, "inputsvc.local_decodes") == N_PARTS - 2
    assert _delta(before, "inputsvc.rpc_errors") >= 1
    assert _delta(before, "inputsvc.fallbacks") == 0


def test_rpc_fault_drill_keeps_identity(server, local_result):
    from sparkdl_tpu_torch.resilience import faults
    faults.inject("inputsvc.rpc", "transient", 0.3, seed=7)
    engine = _engine(f"127.0.0.1:{server.port}")
    try:
        got = _port_collect(engine)
    finally:
        engine.shutdown()
    injected = faults.state()["sites"]["inputsvc.rpc"]["injected"]
    _assert_same(got, local_result)
    assert injected > 0
    assert engine.retries >= 1


def test_engine_pickles_without_sockets(server, local_result):
    engine = _engine(f"127.0.0.1:{server.port}")
    try:
        _port_collect(engine)
        clone = pickle.loads(pickle.dumps(engine))
    finally:
        engine.shutdown()
    try:
        assert clone.inputsvc_endpoints == engine.inputsvc_endpoints
        _assert_same(_port_collect(clone), local_result)
    finally:
        clone.shutdown()
    with pytest.raises(TypeError, match="cannot be pickled"):
        pickle.dumps(server)
    from sparkdl_tpu_torch.inputsvc.client import _Endpoint
    ep = _Endpoint("127.0.0.1", server.port)
    assert ep.connect()
    try:
        copy = pickle.loads(pickle.dumps(ep))
        assert copy.sock is None and not copy.alive
    finally:
        ep.close()


def test_unpicklable_plan_decodes_locally(server, local_result):
    from sparkdl_tpu_torch.data.frame import DataFrame
    engine = _engine(f"127.0.0.1:{server.port}")
    before = _snap()
    try:
        got = DataFrame.from_columns(_columns(), N_PARTS, engine) \
            .map_batches(lambda b: _port_double(b)).collect()
    finally:
        engine.shutdown()
    _assert_same(got, local_result)
    assert _delta(before, "inputsvc.fallbacks") == 1


def test_state_has_the_jax_keys(server):
    from sparkdl_tpu.inputsvc import state as jax_state
    from sparkdl_tpu_torch.inputsvc import state
    engine = _engine(f"127.0.0.1:{server.port}")
    try:
        _port_collect(engine)
    finally:
        engine.shutdown()
    got = state()
    assert {"endpoints", "live_endpoints", "streams_active",
            "counters"} <= set(got)
    assert set(got) - {"workers_live"} <= set(jax_state()) | {
        "endpoints", "live_endpoints"}
    assert got["live_endpoints"] == [f"127.0.0.1:{server.port}"]


# -- snapshot ----------------------------------------------------------------

def _base(engine=None):
    from sparkdl_tpu_torch.data.engine import LocalEngine
    from sparkdl_tpu_torch.data.frame import DataFrame
    return DataFrame.from_columns(_columns(), N_PARTS,
                                  engine or LocalEngine()) \
        .map_batches(_port_double, name="double")


def _store(root):
    (key,) = [d for d in os.listdir(root)
              if os.path.isdir(os.path.join(root, d))]
    return os.path.join(root, key)


def test_snapshot_cold_then_warm_epoch(tmp_path, local_result):
    from sparkdl_tpu_torch.obs import default_registry
    base = _base()
    before = _snap()
    cold = base.snapshot(str(tmp_path), fingerprint="c1")
    _assert_same(cold.collect(), local_result)
    assert _delta(before, "inputsvc.snapshot_misses") == N_PARTS
    assert _delta(before, "inputsvc.snapshot_writes") == N_PARTS
    mid = _snap()
    warm = base.snapshot(str(tmp_path), fingerprint="c1")
    assert warm.schema.keys() == base.schema.keys()
    busy0 = default_registry().counter("engine.busy_seconds").value
    _assert_same(warm.collect(), local_result)
    assert _delta(mid, "inputsvc.snapshot_hits") == N_PARTS
    assert _delta(mid, "inputsvc.snapshot_misses") == 0
    assert default_registry().counter("engine.busy_seconds").value \
        - busy0 < 5.0


def test_snapshot_matches_jax_and_a_pooled_engine(tmp_path, local_result):
    """A warm snapshot read through a thread-pooled engine gives the
    serial rows, and the JAX package's snapshot of the same frame gives
    the same rows."""
    import pyarrow as pa
    import pyarrow.compute as pc
    from sparkdl_tpu.data.frame import DataFrame as JaxFrame
    from sparkdl_tpu_torch.data.engine import LocalEngine
    pooled = LocalEngine(pipeline_workers=2, pipeline_mode="thread")
    try:
        _base(pooled).snapshot(str(tmp_path / "port"), "c1").collect()
        got = _base(pooled).snapshot(str(tmp_path / "port"), "c1").collect()
    finally:
        pooled.shutdown()
    _assert_same(got, local_result)

    def double(batch):
        i = batch.schema.get_field_index("x")
        return batch.set_column(i, "x", pc.multiply(batch.column("x"), 2.0))

    table = pa.table({k: pa.array(v) for k, v in _columns().items()})
    jdf = JaxFrame.from_table(table, N_PARTS).map_batches(double,
                                                          name="double")
    jdf.snapshot(str(tmp_path / "jax"), "c1").collect()
    ref = jdf.snapshot(str(tmp_path / "jax"), "c1").collect()
    _assert_same(got, {n: ref.column(n).to_numpy() for n in ref.column_names})


def test_snapshot_key_changes_with_corpus_config_and_version():
    from sparkdl_tpu.inputsvc import snapshot_key as jax_key
    from sparkdl_tpu_torch.inputsvc import snapshot_key
    assert snapshot_key("corpus-a", "plan") != snapshot_key("corpus-b",
                                                            "plan")
    assert snapshot_key("c1", "double") != snapshot_key("c1",
                                                        "double,resize")
    # another format: a store shared with the JAX package keys apart
    assert snapshot_key("c1", "double") != jax_key("c1", "double")


def test_snapshot_decode_config_change_decodes_cold(tmp_path):
    base = _base()
    base.snapshot(str(tmp_path), "c1").collect()
    before = _snap()
    base.snapshot(str(tmp_path), "c1", decode_key="double-v2").collect()
    assert _delta(before, "inputsvc.snapshot_misses") == N_PARTS
    assert len([d for d in os.listdir(tmp_path)]) == 2


@pytest.mark.parametrize("damage", ["corrupt", "truncate", "missing",
                                    "garbage"])
def test_damaged_chunk_decodes_again(tmp_path, local_result, damage):
    base = _base()
    base.snapshot(str(tmp_path), "c1").collect()
    store = _store(str(tmp_path))
    chunk = os.path.join(store, sorted(
        f for f in os.listdir(store) if f.endswith(".snap"))[3])
    raw = bytearray(open(chunk, "rb").read())
    if damage == "corrupt":
        raw[-1] ^= 0xFF
        open(chunk, "wb").write(raw)
    elif damage == "truncate":
        open(chunk, "wb").write(raw[:len(raw) // 2])
    elif damage == "garbage":
        open(chunk, "wb").write(b"x" * 7)
    else:
        os.remove(chunk)
    before = _snap()
    _assert_same(base.snapshot(str(tmp_path), "c1").collect(), local_result)
    assert _delta(before, "inputsvc.snapshot_misses") == 1
    assert _delta(before, "inputsvc.snapshot_hits") == N_PARTS - 1
    assert _delta(before, "inputsvc.snapshot_corruptions") == \
        (0 if damage == "missing" else 1)
    # the chunk was written anew and validates
    _assert_same(base.snapshot(str(tmp_path), "c1").collect(), local_result)


@pytest.mark.parametrize("damage", ["version", "unreadable"])
def test_manifest_change_invalidates_the_store(tmp_path, local_result,
                                               damage):
    from sparkdl_tpu_torch.inputsvc import snapshot
    base = _base()
    base.snapshot(str(tmp_path), "c1").collect()
    mpath = os.path.join(_store(str(tmp_path)), snapshot.MANIFEST_NAME)
    if damage == "version":
        manifest = json.load(open(mpath))
        manifest["version"] = snapshot.SNAPSHOT_VERSION + 99
        json.dump(manifest, open(mpath, "w"))
    else:
        open(mpath, "w").write("{not json")
    before = _snap()
    _assert_same(base.snapshot(str(tmp_path), "c1").collect(), local_result)
    assert _delta(before, "inputsvc.snapshot_invalidations") == 1
    assert _delta(before, "inputsvc.snapshot_misses") == N_PARTS


def test_snapshot_read_fault_drill(tmp_path, local_result):
    from sparkdl_tpu_torch.resilience import faults
    base = _base()
    base.snapshot(str(tmp_path), "c1").collect()
    before = _snap()
    faults.inject("snapshot.read", "transient", 1.0)
    _assert_same(base.snapshot(str(tmp_path), "c1").collect(), local_result)
    assert _delta(before, "inputsvc.snapshot_corruptions") == N_PARTS


def test_chunk_round_trip_and_digest(tmp_path):
    from sparkdl_tpu_torch.data.codec import decode_batch
    from sparkdl_tpu_torch.inputsvc import snapshot
    batch = {"a": np.arange(1000, dtype=np.int32), "s": np.array(
        ["p", None], dtype=object)[np.arange(1000) % 2]}
    path = str(tmp_path / "c.snap")
    snapshot._write_chunk(path, batch)
    out = decode_batch(snapshot._read_chunk(path))
    assert out["a"].tobytes() == batch["a"].tobytes()
    assert list(out["s"]) == list(batch["s"])
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0x01
    open(path, "wb").write(raw)
    with pytest.raises(snapshot.SnapshotCorruption):
        snapshot._read_chunk(path)


# -- CLI ---------------------------------------------------------------------

def test_serve_ready_line_ping_and_decode(local_result):
    """``python -m sparkdl_tpu_torch.inputsvc serve --port 0`` prints its
    READY line with the bound endpoint, answers a ping, and serves a
    fleet of one with the serial rows."""
    from sparkdl_tpu_torch.inputsvc import recv_msg, send_msg, transport
    from sparkdl_tpu_torch.inputsvc.__main__ import READY
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # the server imports this module for the plan's stage
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests")])
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparkdl_tpu_torch.inputsvc", "serve",
         "--port", "0"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=env, cwd=REPO)
    try:
        line = _ready_line(proc)
        endpoint = line.rsplit(" ", 1)[-1]
        host, port = transport.parse_endpoint(endpoint)
        with socket.create_connection((host, port), timeout=10) as sock:
            send_msg(sock, {"op": "ping"})
            header, _ = recv_msg(sock)
        assert header["ok"] is True
        assert header["version"] == transport.WIRE_VERSION
        assert header["pid"] == proc.pid
        engine = _engine(endpoint)
        try:
            _assert_same(_port_collect(engine), local_result)
        finally:
            engine.shutdown()
    finally:
        proc.terminate()
        # the reader thread drains stdout, so the wait cannot block on it
        proc.wait(timeout=15)
    assert READY in line


def _ready_line(proc):
    """The server's READY line, read with a bound (a thread reads the
    pipe, so a server that never prints cannot hang the test)."""
    import queue
    import threading
    from sparkdl_tpu_torch.inputsvc.__main__ import READY
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            break
        if READY in line:
            return line.strip()
    raise AssertionError("no READY line within the bound")


def test_serve_rejects_a_bad_subcommand():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "sparkdl_tpu_torch.inputsvc", "bogus"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode != 0
