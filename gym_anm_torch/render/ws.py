"""Minimal RFC 6455 WebSocket broadcast server (pure stdlib).

Port of ``gym_anm_tpu/render/ws.py``, unchanged in behaviour.  A
replacement for the reference's ``websocket-server``-backed
``WsServer`` (``rendering/py/servers.py:14-141``): the same hub semantics —
browser clients connect and receive every message the environment
publishes, with the most recent ``init`` message replayed to late joiners —
but implemented on ``socket``/``threading`` with no third-party
dependency, and running as daemon THREADS in the env process rather than a
forked ``multiprocessing.Process`` (forking a process that holds a live
CUDA context is unsafe; threads also let the env broadcast directly instead
of opening a loopback client connection per frame, which is what made the
reference's ``update()`` cost a TCP handshake per step).
"""

import base64
import hashlib
import json
import queue
import socket
import struct
import threading

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class _BufferedSock:
    """Socket wrapper that replays bytes read past the handshake terminator
    (frames sent immediately after the 101 response would otherwise be
    swallowed by the header read)."""

    def __init__(self, sock, initial=b""):
        self._sock = sock
        self._buf = initial

    def recv(self, n):
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            return out
        return self._sock.recv(n)

    def sendall(self, data):
        self._sock.sendall(data)

    def close(self):
        self._sock.close()


def encode_frame(payload: bytes, opcode: int = 0x1) -> bytes:
    """Server→client frame (FIN set, unmasked)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


def decode_frame(sock):
    """Read one client→server frame; returns (opcode, payload)."""
    b1, b2 = _read_exact(sock, 2)
    opcode = b1 & 0x0F
    masked = b2 & 0x80
    n = b2 & 0x7F
    if n == 126:
        n = struct.unpack(">H", _read_exact(sock, 2))[0]
    elif n == 127:
        n = struct.unpack(">Q", _read_exact(sock, 8))[0]
    if masked:
        key = _read_exact(sock, 4)
        data = bytearray(_read_exact(sock, n))
        for i in range(n):
            data[i] ^= key[i % 4]
        payload = bytes(data)
    else:
        payload = _read_exact(sock, n)
    return opcode, payload


def handshake_response(key: str) -> bytes:
    accept = base64.b64encode(
        hashlib.sha1((key + _WS_GUID).encode()).digest()
    ).decode()
    return (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
    ).encode()


class WsServer:
    """Broadcast hub: every message sent via :meth:`broadcast` reaches all
    connected clients; the latest init message is replayed to new clients
    (servers.py:47-60 semantics)."""

    def __init__(self, host="127.0.0.1", port=0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.host, self.port = self._sock.getsockname()
        self.address = f"ws://{self.host}:{self.port}"
        self._clients = []
        self._lock = threading.Lock()
        self._last_init = None
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    # -- server side ----------------------------------------------------
    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_client, args=(conn,), daemon=True).start()

    def _serve_client(self, conn):
        client = None
        try:
            conn.settimeout(10.0)  # bound half-open handshakes
            request = b""
            while b"\r\n\r\n" not in request:
                chunk = conn.recv(4096)
                if not chunk:  # EOF before the header terminator
                    conn.close()
                    return
                request += chunk
            conn.settimeout(None)
            headers, _, leftover = request.partition(b"\r\n\r\n")
            key = None
            for line in headers.decode("latin1").split("\r\n"):
                if line.lower().startswith("sec-websocket-key:"):
                    key = line.split(":", 1)[1].strip()
            if key is None:
                conn.close()
                return
            conn.sendall(handshake_response(key))
            conn = _BufferedSock(conn, leftover)
            # Decouple slow readers from the publisher: frames go through a
            # bounded per-client queue drained by a writer thread, so a
            # frozen browser tab can never block the env's broadcast()
            # (sendall under a shared lock would).  When the queue fills,
            # old frames are dropped — rendering frames are disposable.
            outbox = queue.Queue(maxsize=64)
            client = (conn, outbox)
            threading.Thread(target=self._writer, args=(conn, outbox), daemon=True).start()
            with self._lock:
                self._clients.append(client)
                if self._last_init is not None:
                    outbox.put(self._last_init)
            # Service pings/closes from this client.
            while self._running:
                opcode, payload = decode_frame(conn)
                if opcode == 0x8:  # close
                    break
                if opcode == 0x9:  # ping -> pong (pre-framed)
                    outbox.put(("raw", encode_frame(payload, opcode=0xA)))
                # Text messages from clients are relayed like the reference
                # hub does (servers.py:47-60) — the browser never sends any,
                # but an env-side client may.
                if opcode == 0x1:
                    self._relay(payload, exclude=client)
        except (ConnectionError, OSError):
            pass
        finally:
            self._drop(client)
            try:
                conn.close()
            except OSError:
                pass

    def _writer(self, conn, outbox):
        while self._running:
            item = outbox.get()
            if item is None:  # shutdown sentinel
                return
            try:
                data = item[1] if isinstance(item, tuple) else encode_frame(item)
                conn.sendall(data)
            except OSError:
                return

    def _drop(self, client):
        if client is None:
            return
        with self._lock:
            if client in self._clients:
                self._clients.remove(client)
        try:
            client[1].put_nowait(None)
        except queue.Full:
            pass

    def _relay(self, payload: bytes, exclude=None):
        try:
            msg = json.loads(payload.decode())
            if msg.get("messageLabel") == "init":
                self._last_init = payload
        except (ValueError, UnicodeDecodeError):
            pass
        with self._lock:
            targets = [c for c in self._clients if c is not exclude]
        for c in targets:
            try:
                c[1].put_nowait(payload)
            except queue.Full:
                try:  # drop the oldest frame, keep the newest
                    c[1].get_nowait()
                    c[1].put_nowait(payload)
                except (queue.Empty, queue.Full):
                    pass

    # -- env side -------------------------------------------------------
    def broadcast(self, message: str):
        """Publish a JSON string to all connected browser clients."""
        self._relay(message.encode())

    def stop(self):
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            for conn, outbox in self._clients:
                try:
                    outbox.put_nowait(None)
                except queue.Full:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
            self._clients.clear()


class WsClient:
    """Tiny stdlib WebSocket client (used by tests and by out-of-process
    publishers; the in-process env publishes via WsServer.broadcast)."""

    def __init__(self, address: str, timeout=5.0):
        host, port = address.replace("ws://", "").split(":")
        self.sock = socket.create_connection((host, int(port)), timeout=timeout)
        key = base64.b64encode(b"0123456789abcdef").decode()
        self.sock.sendall(
            (
                f"GET / HTTP/1.1\r\nHost: {host}:{port}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("server closed during handshake")
            resp += chunk
        if b"101" not in resp.split(b"\r\n", 1)[0]:
            raise ConnectionError(f"handshake failed: {resp[:120]!r}")
        leftover = resp.partition(b"\r\n\r\n")[2]
        self.sock = _BufferedSock(self.sock, leftover)

    def send(self, message: str):
        # Client→server frames must be masked (RFC 6455 §5.3).
        payload = bytearray(message.encode())
        key = b"\x00\x00\x00\x00"  # zero mask: masked bit set, data unchanged
        head = bytes([0x81])
        n = len(payload)
        if n < 126:
            head += bytes([0x80 | n])
        elif n < 1 << 16:
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack(">Q", n)
        self.sock.sendall(head + key + bytes(payload))

    def recv(self) -> str:
        opcode, payload = decode_frame(self.sock)
        return payload.decode()

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
