"""The port's WebSocket bridge (`deepfilternet_torch/serve_ws.py`) on the
port's server, the cases of `tests/test_serve_ws.py`: the RFC 6455
handshake, a binary hop round trip held against JAX's
`StreamingRuntime.process` at atol 1e-5, ping/pong, the demo page, and the
frame codec against JAX's."""

import base64
import hashlib
import os
import socket
import struct
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepfilternet_tpu import serve_ws as j_serve_ws  # noqa: E402
from deepfilternet_torch.serve_ws import (  # noqa: E402
    _WS_GUID,
    WsBridge,
    _recv_exact,
    read_ws_frame,
    send_ws_frame,
)
from tests._torch_serving import (  # noqa: E402
    ATOL,
    HOP,
    jax_reference,
    load_models,
    port_config,
    torch_server,
)


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    with port_config():
        yield


@pytest.fixture(scope="module")
def bridge():
    jm, jd, tm, td = load_models()
    with torch_server(tm, td) as srv:
        ws = WsBridge(srv, port=0).start()
        try:
            yield jm, jd, ws.port
        finally:
            ws.stop()


def _ws_connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    key = base64.b64encode(os.urandom(16)).decode()
    s.sendall((f"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
               f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
               f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += s.recv(4096)
    assert b"101" in resp.split(b"\r\n")[0]
    assert base64.b64encode(hashlib.sha1((key + _WS_GUID).encode()).digest()) in resp
    return s


def _send_masked(s, payload: bytes, opcode=0x2):
    mask = os.urandom(4)
    m = (mask * (len(payload) // 4 + 1))[: len(payload)]
    masked = bytes(a ^ b for a, b in zip(payload, m))
    ln = len(payload)
    if ln < 126:
        hdr = bytes([0x80 | opcode, 0x80 | ln])
    else:
        hdr = bytes([0x80 | opcode, 0x80 | 126]) + struct.pack(">H", ln)
    s.sendall(hdr + mask + masked)


def test_round_trip_matches_jax(bridge, rng):
    jm, jd, port = bridge
    s = _ws_connect(port)
    audio = (rng.standard_normal((1, HOP * 4)) * 0.1).astype(np.float32)
    outs = []
    for i in range(4):
        _send_masked(s, audio[0, i * HOP: (i + 1) * HOP].tobytes())
        op, payload = read_ws_frame(s)
        assert op == 0x2
        outs.append(np.frombuffer(payload, "<f4"))
    _send_masked(s, b"", opcode=0x8)
    s.close()
    np.testing.assert_allclose(np.concatenate(outs), jax_reference(jm, jd, audio)[0],
                               rtol=0, atol=ATOL)


def test_partial_hop_gets_an_empty_frame(bridge):
    _, _, port = bridge
    s = _ws_connect(port)
    _send_masked(s, np.zeros(100, np.float32).tobytes())
    assert read_ws_frame(s) == (0x2, b"")
    s.close()


def test_ping_pong(bridge):
    _, _, port = bridge
    s = _ws_connect(port)
    _send_masked(s, b"hello", opcode=0x9)
    assert read_ws_frame(s) == (0xA, b"hello")
    s.close()


def test_serves_demo_page(bridge):
    _, _, port = bridge
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    s.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
    resp = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        resp += chunk
    s.close()
    assert b"200 OK" in resp and b"DeepFilterNet" in resp
    assert b"WebSocket" in resp


def _sent(send, payload: bytes, opcode: int):
    """The bytes `send(sock, payload, opcode)` puts on a socket, and the
    frame `read_ws_frame` reads back from them."""
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=send, args=(a, payload, opcode))
        t.start()
        n = len(payload)
        raw = _recv_exact(b, n + (2 if n < 126 else 4 if n < 1 << 16 else 10))
        t.join(10)
        a.sendall(raw)
        return raw, read_ws_frame(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("n_bytes", [0, 125, 126, 65535, 65536])
def test_frame_codec_matches_jax(n_bytes):
    """Each length form (7-bit, 16-bit, 64-bit) of a server frame is the
    bytes JAX's bridge sends, and reads back."""
    payload = bytes(range(256)) * (n_bytes // 256) + bytes(n_bytes % 256)
    ours, frame = _sent(send_ws_frame, payload, 0x1)
    theirs, _ = _sent(j_serve_ws.send_ws_frame, payload, 0x1)
    assert ours == theirs
    assert frame == (0x1, payload)
