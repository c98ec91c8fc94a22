"""WebSocket bridge + browser demo page for the stream server.

The port of `deepfilternet_tpu/serve_ws.py`. The model lives server-side,
so the browser is a thin client: this module bridges WebSocket connections
(binary frames of float32 48 kHz hops) onto the TCP stream server's slot
pool (`serve.py`), and serves a self-contained demo page
(`deepfilternet_torch/web/demo.html`: live mic or synthetic noise source,
side-by-side noisy/enhanced spectrograms, DF toggle).

RFC 6455 is implemented directly (handshake + masked binary frames +
ping/close), with no websocket dependency.

Run:  python -m deepfilternet_torch.serve --ws-port 7861
then open http://127.0.0.1:7861/ in a browser.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import threading
from typing import Optional

import numpy as np

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_HTML_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "web", "demo.html")


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_ws_frame(conn: socket.socket) -> Optional[tuple]:
    """Returns (opcode, payload bytes) or None on EOF/protocol error."""
    hdr = _recv_exact(conn, 2)
    if hdr is None:
        return None
    opcode = hdr[0] & 0x0F
    masked = hdr[1] & 0x80
    ln = hdr[1] & 0x7F
    if ln == 126:
        ext = _recv_exact(conn, 2)
        if ext is None:
            return None
        ln = struct.unpack(">H", ext)[0]
    elif ln == 127:
        ext = _recv_exact(conn, 8)
        if ext is None:
            return None
        ln = struct.unpack(">Q", ext)[0]
    mask = _recv_exact(conn, 4) if masked else b"\x00" * 4
    if mask is None:
        return None
    payload = _recv_exact(conn, ln) if ln else b""
    if payload is None:
        return None
    if masked:
        m = np.frombuffer((mask * (ln // 4 + 1))[:ln], np.uint8)
        payload = (np.frombuffer(payload, np.uint8) ^ m).tobytes()
    return opcode, payload


def send_ws_frame(conn: socket.socket, payload: bytes, opcode: int = 0x2):
    """Server->client frame (unmasked)."""
    ln = len(payload)
    if ln < 126:
        hdr = bytes([0x80 | opcode, ln])
    elif ln < 1 << 16:
        hdr = bytes([0x80 | opcode, 126]) + struct.pack(">H", ln)
    else:
        hdr = bytes([0x80 | opcode, 127]) + struct.pack(">Q", ln)
    conn.sendall(hdr + payload)


class WsBridge:
    """Accepts WebSocket/HTTP connections; binary WS frames carry whole
    float32 hops into the StreamServer slot pool; plain GETs receive the
    demo page."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 7861):
        self.server = server
        self.host = host
        self.port = port
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Bind (port 0 picks a free port, then kept in `self.port`) and start
        the accept thread."""
        self._sock = socket.create_server((self.host, self.port))
        self._sock.settimeout(0.5)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        if self._thread is not None:
            self._thread.join(5.0)

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    # -- connection --------------------------------------------------------

    def _handle(self, conn: socket.socket):
        slot = None
        try:
            head = b""
            while b"\r\n\r\n" not in head:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                head += chunk
            request = head.decode("latin1")
            key = None
            for line in request.split("\r\n"):
                if line.lower().startswith("sec-websocket-key:"):
                    key = line.split(":", 1)[1].strip()
            if key is None:
                # plain HTTP: serve the demo page
                try:
                    body = open(_HTML_PATH, "rb").read()
                except OSError:
                    body = b"demo.html missing"
                conn.sendall(
                    b"HTTP/1.1 200 OK\r\nContent-Type: text/html\r\n"
                    + f"Content-Length: {len(body)}\r\n\r\n".encode()
                    + body
                )
                return
            accept = base64.b64encode(
                hashlib.sha1((key + _WS_GUID).encode()).digest()
            ).decode()
            conn.sendall(
                ("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                 "Connection: Upgrade\r\n"
                 f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode()
            )
            slot = self.server._alloc_slot()
            if slot is None:
                send_ws_frame(conn, b"", opcode=0x8)  # pool exhausted
                return
            hop = self.server.hop
            while not self._stop.is_set():
                frame = read_ws_frame(conn)
                if frame is None:
                    break
                opcode, payload = frame
                if opcode == 0x8:  # close
                    break
                if opcode == 0x9:  # ping -> pong
                    send_ws_frame(conn, payload, opcode=0xA)
                    continue
                if opcode not in (0x1, 0x2):
                    continue
                audio = np.frombuffer(payload, "<f4")
                if audio.size == 0 or audio.size % hop != 0:
                    send_ws_frame(conn, b"")
                    continue
                outs = [
                    self.server._submit(slot, audio[i : i + hop])
                    for i in range(0, audio.size, hop)
                ]
                send_ws_frame(conn, np.concatenate(outs).astype("<f4").tobytes())
        except (OSError, RuntimeError):
            pass  # the client went away, or the server is stopping
        finally:
            if slot is not None:
                self.server._release_slot(slot)
            conn.close()
