"""The port's MCP server and client transport, held to the JAX package's
tests/test_properties_bridge.py property for property.

Property-based tests for the MCP wire protocol and the client/bridge
transport — parity with the reference's bridge property suite
(examples/test_socket_handler.py:30-138: connection resilience and
complete-message-reading properties), applied to this stack's framing:

  * server-side framing under ADVERSARIAL CHUNKING: newline-delimited and
    concatenated JSON objects, garbage interleave, and chunk splits at
    arbitrary byte offsets — including through multi-byte UTF-8 sequences
    (serve/mcp_server.py:140-210 incremental decoder);
  * SocketHandler complete-message reading under arbitrary server-side
    write chunking;
  * SocketHandler reconnect resilience: repeated connection loss, both
    detected by the proactive health check and recovered mid-request.
"""

import json
import socket
import threading
import time

import pytest
from hypothesis import given, settings, strategies as st

from erlvectordb_tpu_torch.serve.client import SocketHandler

# ---------------------------------------------------------------------------
# server fixture (one per module: a Database boot is too heavy per-example)
# ---------------------------------------------------------------------------

_SERVER = {}


def _mcp_port(tmp_path_factory) -> int:
    if "port" in _SERVER:
        return _SERVER["port"]
    from erlvectordb_tpu_torch.api import Database
    from erlvectordb_tpu_torch.infra.config import load_config
    from erlvectordb_tpu_torch.serve.mcp_server import MCPServer

    tmp = tmp_path_factory.mktemp("props_bridge")
    cfg = load_config(overrides={
        "persistence_dir": str(tmp / "data"),
        "backup_dir": str(tmp / "backups"),
        "sync_interval": 9999,
    }, env={})
    db = Database(cfg, device="cpu").start()
    srv = MCPServer(db, port=0).start()
    _SERVER["db"] = db
    _SERVER["srv"] = srv
    _SERVER["port"] = srv._sock.getsockname()[1]
    return _SERVER["port"]


@pytest.fixture(scope="module")
def mcp_port(tmp_path_factory):
    yield _mcp_port(tmp_path_factory)
    if _SERVER:
        _SERVER.pop("srv").stop()
        _SERVER.pop("db").stop()
        _SERVER.pop("port", None)


# ---------------------------------------------------------------------------
# property 1: framing survives adversarial chunking
# ---------------------------------------------------------------------------

# unicode-heavy method params force multi-byte UTF-8 onto the wire
_UNI = st.text(
    alphabet=st.characters(min_codepoint=0x20, max_codepoint=0x24FF,
                           blacklist_categories=("Cs",)),
    min_size=0, max_size=24)

# garbage that cannot begin a JSON value (so the decoder must line-drop it):
# symbols only, no quotes/braces/brackets/digits/minus/t/f/n
_GARBAGE = st.text(alphabet="@#$%^&*~`|;:!?<>", min_size=1, max_size=16)


@settings(max_examples=20, deadline=None)
@given(
    payloads=st.lists(_UNI, min_size=1, max_size=8),
    joins=st.lists(st.booleans(), min_size=8, max_size=8),   # newline or not
    garbage=st.lists(st.tuples(st.integers(0, 7), _GARBAGE),
                     min_size=0, max_size=3),
    chunk_seed=st.integers(0, 2**31 - 1),
)
def test_mcp_framing_adversarial_chunking(tmp_path_factory, payloads, joins,
                                          garbage, chunk_seed):
    """For ANY mix of newline-delimited and concatenated JSON-RPC requests,
    interleaved with garbage lines, split into chunks at arbitrary byte
    offsets (including mid-UTF-8): the server answers every valid request
    with its id intact and in order, and every garbage line draws exactly
    one parse error — nothing is silently dropped or corrupted."""
    port = _mcp_port(tmp_path_factory)
    import random

    rnd = random.Random(chunk_seed)
    garbage_before = {}
    for pos, g in garbage:
        garbage_before.setdefault(pos % len(payloads), []).append(g)

    parts = []
    expect_ids = []
    n_garbage = 0
    for i, text in enumerate(payloads):
        for g in garbage_before.get(i, ()):
            parts.append(g + "\n")          # newline-terminated garbage line
            n_garbage += 1
        req = {"jsonrpc": "2.0", "id": 1000 + i, "method": "ping",
               "params": {"echo": text}}
        expect_ids.append(1000 + i)
        parts.append(json.dumps(req, ensure_ascii=False))
        if joins[i % len(joins)]:
            parts.append("\n")              # else: concatenated objects
    stream = "".join(parts).encode("utf-8")

    conn = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        # send in random-size chunks, splitting at BYTE offsets (multi-byte
        # code points straddle chunk boundaries)
        at = 0
        while at < len(stream):
            n = rnd.randint(1, 17)
            conn.sendall(stream[at:at + n])
            at += n
            if rnd.random() < 0.3:
                time.sleep(0.001)           # let the server drain mid-split
        want = len(expect_ids) + n_garbage
        buf = b""
        while buf.count(b"\n") < want:
            chunk = conn.recv(65536)
            assert chunk, "server closed before all responses arrived"
            buf += chunk
        lines = buf.decode().strip().split("\n")[:want]
        resps = [json.loads(l) for l in lines]
        got_ids = [r["id"] for r in resps if "result" in r]
        errors = [r for r in resps if "error" in r]
        assert got_ids == expect_ids
        assert len(errors) == n_garbage
        assert all(e["error"]["code"] == -32700 for e in errors)
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# property 2: complete message reading through SocketHandler
# ---------------------------------------------------------------------------


def _chunked_echo_server(splits_seed: int):
    """One-shot echo server: reads a line, writes the SAME bytes back in
    random-size chunks (splitting multi-byte UTF-8), then keeps serving."""
    import random

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    port = srv.getsockname()[1]
    stop = threading.Event()
    rnd = random.Random(splits_seed)

    def run():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                buf = b""
                while b"\n" not in buf:
                    c = conn.recv(65536)
                    if not c:
                        raise OSError
                    buf += c
                line = buf.split(b"\n", 1)[0] + b"\n"
                at = 0
                while at < len(line):
                    n = rnd.randint(1, 5)
                    conn.sendall(line[at:at + n])
                    at += n
                    time.sleep(0.0005)
            except OSError:
                pass
            finally:
                conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def shutdown():
        stop.set()
        srv.close()

    return port, shutdown


@settings(max_examples=15, deadline=None)
@given(
    msg=st.dictionaries(keys=_UNI.filter(bool), values=st.one_of(
        _UNI, st.integers(), st.booleans(), st.none(),
        st.floats(allow_nan=False, allow_infinity=False)),
        min_size=1, max_size=8),
    seed=st.integers(0, 2**31 - 1),
)
def test_socket_handler_complete_message_reading(msg, seed):
    """For ANY JSON message the server chunks arbitrarily (1-5 byte writes,
    mid-UTF-8 splits), SocketHandler.request returns the intact object —
    the reference's 'complete message reading' property
    (examples/test_socket_handler.py:120-138)."""
    port, shutdown = _chunked_echo_server(seed)
    try:
        h = SocketHandler("127.0.0.1", port, timeout=10, idle_check_s=0)
        assert h.request(msg) == json.loads(json.dumps(msg))
        h.close()
    finally:
        shutdown()


# ---------------------------------------------------------------------------
# property 3: reconnect resilience (health check + mid-request recovery)
# ---------------------------------------------------------------------------


def _flaky_echo_server(n_disconnects: int):
    """Accepts and immediately closes the first ``n_disconnects``
    connections, then serves line echoes forever."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    port = srv.getsockname()[1]
    stop = threading.Event()

    def run():
        dropped = 0
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            if dropped < n_disconnects:
                conn.close()
                dropped += 1
                continue
            try:
                buf = b""
                while not stop.is_set():
                    c = conn.recv(65536)
                    if not c:
                        break
                    buf += c
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        conn.sendall(line + b"\n")
            except OSError:
                pass
            finally:
                conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def shutdown():
        stop.set()
        srv.close()

    return port, shutdown


@settings(max_examples=10, deadline=None)
@given(n_disconnects=st.integers(1, 3))
def test_socket_handler_reconnect_resilience(n_disconnects):
    """For ANY number of connection losses, the handler detects the dead
    connection via check_health (non-destructive MSG_PEEK) and reconnects
    before the next request is spent — the reference's 'connection
    resilience' property (examples/test_socket_handler.py:30-115)."""
    port, shutdown = _flaky_echo_server(n_disconnects)
    try:
        h = SocketHandler("127.0.0.1", port, timeout=10, max_reconnects=5,
                          idle_check_s=0)
        h.connect()
        for _ in range(n_disconnects):
            # wait for the remote FIN of the dropped connection to land
            deadline = time.time() + 2
            while h.check_health() and time.time() < deadline:
                time.sleep(0.01)
            assert not h.check_health()
            assert h.state == "disconnected"
            h.connect()
        assert h.request({"id": 7}) == {"id": 7}
        h.close()
    finally:
        shutdown()


def test_socket_handler_proactive_idle_reconnect():
    """An idle connection killed by the server is re-established BEFORE the
    next request is written into the dead socket (the proactive path the
    reference bridge runs via check_connection_health,
    gemini_mcp_server.py:261-300)."""
    port, shutdown = _flaky_echo_server(1)
    try:
        h = SocketHandler("127.0.0.1", port, timeout=10, idle_check_s=0.01)
        h.connect()                       # connection #1: server drops it
        time.sleep(0.1)                   # idle past idle_check_s; FIN lands
        assert h.request({"id": 1}) == {"id": 1}
        assert h.reconnects == 1          # recovered proactively, not mid-IO
        h.close()
    finally:
        shutdown()
