"""HTTP/SSE endpoint for the telemetry bridge (stdlib only).

Three endpoints, INAM-dashboard shaped:

  ``GET /metrics``   latest cumulative snapshot (JSON)
  ``GET /findings``  detector findings so far (JSON list)
  ``GET /stream``    live delta/finding frames as Server-Sent Events
                     (``data: <frame-json>\\n\\n``); the ring buffer is
                     replayed first so late joiners see recent history

``/stream`` clients each get a bounded :class:`ClientQueue`: a slow
curl never blocks the poll thread, it just loses the oldest frames
(reported via an ``: dropped N`` comment line). Idle streams get
keep-alive comment lines so proxies don't cut them.

Robustness: binding retries with exponential backoff when the
requested port is busy (``EADDRINUSE``), falling back to an ephemeral
port on the last attempt (reported via ``fell_back``/
``requested_port`` so harnesses can log the substitution);
``stop()``/``close()`` are idempotent and safe on a never-started
server; a half-closed or vanished SSE client can only stall its own
daemon handler thread up to the socket timeout — every stream write
error (not just the polite pipe/reset pair) detaches that client's
queue, so the bridge's poll thread is never wedged.

A copy of ``repro.telemetry.server``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import errno
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .bridge import TelemetryBridge
from .subscribers import ClientQueue

KEEPALIVE_S = 5.0
BIND_RETRIES = 4
BIND_BACKOFF_S = 0.05


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-telemetry/1"
    # socket timeout: a client that half-closes (or disappears without
    # a RST) leaves writes filling the kernel buffer; the timeout turns
    # that into an OSError the stream loop treats as a disconnect
    timeout = 6 * KEEPALIVE_S

    # quiet: the poll thread's work must not be interleaved with access
    # logs on stderr during benches
    def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
        pass

    @property
    def bridge(self) -> TelemetryBridge:
        return self.server.bridge  # type: ignore[attr-defined]

    def _send_json(self, payload, status: int = 200) -> None:
        body = json.dumps(payload, separators=(",", ":")).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib name)
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            self._send_json(self.bridge.metrics())
        elif path == "/findings":
            self._send_json(self.bridge.findings_json())
        elif path == "/stream":
            self._stream()
        elif path == "/":
            self._send_json({"endpoints": ["/metrics", "/findings",
                                           "/stream"],
                             "session": self.bridge.session})
        else:
            self._send_json({"error": f"no such endpoint {path!r}"},
                            status=404)

    def _stream(self) -> None:
        queue = ClientQueue(capacity=256)
        # subscribe() first, ring replay second: a frame pushed between
        # the two shows up twice at worst, never not at all.
        self.bridge.subscribe(queue)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Connection", "close")
            self.end_headers()
            for frame in self.bridge.ring.frames():
                self._send_frame(frame)
            reported_drops = 0
            while not self.server.stopping:  # type: ignore[attr-defined]
                frame = queue.pop(timeout=KEEPALIVE_S)
                if frame is None:
                    if queue.closed:
                        break
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
                    continue
                if queue.dropped > reported_drops:
                    d = queue.dropped - reported_drops
                    reported_drops = queue.dropped
                    self.wfile.write(f": dropped {d}\n\n".encode())
                self._send_frame(frame)
                if frame.get("t") == "te":
                    break
        except OSError:
            # BrokenPipe/ConnectionReset from a closed peer, timeouts
            # from a half-closed one that stopped reading — either way
            # this client is done; detach it so the poller's fan-out
            # never touches a dead queue again
            pass
        finally:
            self.bridge.unsubscribe(queue)
            queue.close()

    def _send_frame(self, frame) -> None:
        data = json.dumps(frame, separators=(",", ":"))
        self.wfile.write(f"data: {data}\n\n".encode("utf-8"))
        self.wfile.flush()


class TelemetryServer:
    """Bind the bridge to an HTTP port (port 0 = ephemeral).

    ``start()`` serves on a daemon thread and returns the server;
    ``stop()`` (alias ``close()``, both idempotent) wakes streaming
    clients and shuts the listener down. A busy requested port is
    retried ``bind_retries`` times with exponential backoff, then the
    OS picks an ephemeral port instead — check ``fell_back`` /
    ``requested_port`` and report the substituted ``port`` rather than
    failing a long bench run over a stale listener."""

    def __init__(self, bridge: TelemetryBridge, host: str = "127.0.0.1",
                 port: int = 0, bind_retries: int = BIND_RETRIES,
                 bind_backoff_s: float = BIND_BACKOFF_S):
        self.bridge = bridge
        self.requested_port = port
        self.fell_back = False
        self._httpd = self._bind(host, port, bind_retries,
                                 bind_backoff_s)
        self._httpd.daemon_threads = True
        self._httpd.bridge = bridge          # type: ignore[attr-defined]
        self._httpd.stopping = False         # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def _bind(self, host: str, port: int, retries: int,
              backoff_s: float) -> ThreadingHTTPServer:
        attempt = 0
        while True:
            try:
                return ThreadingHTTPServer((host, port), _Handler)
            except OSError as e:
                if e.errno != errno.EADDRINUSE or port == 0:
                    raise
                attempt += 1
                if attempt > retries:
                    # last resort: let the OS pick — the caller reads
                    # the substituted port off ``url`` and can see the
                    # fallback happened via ``fell_back``
                    self.fell_back = True
                    return ThreadingHTTPServer((host, 0), _Handler)
                time.sleep(backoff_s * (2 ** (attempt - 1)))

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "TelemetryServer":
        if self._closed:
            raise RuntimeError("telemetry server already closed")
        if self._thread is not None:
            raise RuntimeError("telemetry server already started")
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="telemetry-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.stopping = True          # type: ignore[attr-defined]
        if self._thread is not None:
            # shutdown() blocks until serve_forever acknowledges — only
            # meaningful (and only safe) when the loop actually ran
            self._httpd.shutdown()
            self._thread.join()
            self._thread = None
        self._httpd.server_close()

    # idempotent alias, symmetric with TelemetryBridge.close()
    close = stop

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
