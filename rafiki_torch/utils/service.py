"""JSON-over-HTTP service plumbing on the stdlib ``http.server``.

The port's copy of ``rafiki_tpu/utils/service.py`` reduced to what its
routes need: routes matched on exact ``(method, path)``, JSON bodies
in and out, replies streamed with chunked transfer encoding, a cap on
the body size, graceful start and stop.

A handler is ``handler(body) -> (status, obj)``; ``obj`` is sent as
JSON, or streamed when it is a ``StreamResponse``. It may raise
``HttpError`` for a chosen status; a ``ValueError`` answers 400 and any
other exception 500.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

_log = logging.getLogger(__name__)

Handler = Callable[[Optional[Dict[str, Any]]], Tuple[int, Any]]


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class StreamResponse:
    """A handler return value streamed as chunked transfer encoding.

    ``chunks`` is a LAZY iterable of str/bytes fragments — the handler
    returns at once and the fragments are produced while the response
    is being written, which is what the generative token stream needs
    (each token frame reaches the client as soon as the decode loop
    emits it). A client that disconnects mid-stream ends the iteration;
    the generator's ``finally`` runs either way.
    """

    def __init__(self, content_type: str, chunks):
        self.content_type = content_type
        self.chunks = chunks


class JsonHttpServer:
    """A route-table HTTP server. ``port=0`` picks a free port."""

    def __init__(self, routes: List[Tuple[str, str, Handler]],
                 host: str = "127.0.0.1", port: int = 0,
                 name: str = "http", max_body: int = 64 << 20):
        self.name = name
        self.max_body = max_body
        self._routes = {(method.upper(), path): handler
                        for method, path, handler in routes}
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                _log.debug("%s " + fmt, name, *args)

            def _dispatch(self, method: str):
                length = int(self.headers.get("Content-Length") or 0)
                if length > outer.max_body:
                    self.close_connection = True
                    self._reply(413, {"error": f"request body {length} "
                                      f"bytes exceeds {outer.max_body}"})
                    return
                body = None
                if length:
                    try:
                        body = json.loads(self.rfile.read(length))
                    except json.JSONDecodeError:
                        self._reply(400, {"error": "invalid JSON body"})
                        return
                handler = outer._routes.get((method, self.path))
                if handler is None:
                    self._reply(404, {"error": f"no route {method} "
                                               f"{self.path}"})
                    return
                try:
                    status, obj = handler(body)
                except HttpError as e:
                    status, obj = e.status, {"error": e.message}
                except ValueError as e:
                    status, obj = 400, {"error": str(e)}
                except Exception as e:  # the server keeps serving
                    _log.exception("%s %s failed", method, self.path)
                    status, obj = 500, {"error": f"{type(e).__name__}: {e}"}
                self._reply(status, obj)

            def _reply(self, status: int, obj: Any):
                if isinstance(obj, StreamResponse):
                    self._reply_stream(status, obj)
                    return
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _reply_stream(self, status: int, obj: StreamResponse):
                """One HTTP chunk per fragment, flushed at once. A
                broken pipe (client gone) stops the iteration and closes
                the connection; the source iterator is always closed, so
                its ``finally`` blocks run."""
                self.send_response(status)
                self.send_header("Content-Type", obj.content_type)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                it = iter(obj.chunks)
                try:
                    for chunk in it:
                        if isinstance(chunk, str):
                            chunk = chunk.encode()
                        if not chunk:
                            continue
                        self.wfile.write(b"%x\r\n" % len(chunk)
                                         + chunk + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:  # broken pipe, reset: the client left
                    self.close_connection = True
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()

            def do_POST(self):
                self._dispatch("POST")

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "JsonHttpServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"{self.name}-http",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
