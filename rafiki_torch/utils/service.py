"""JSON-over-HTTP service plumbing on the stdlib ``http.server``.

The port's copy of ``rafiki_tpu/utils/service.py``: a route table whose paths may hold ``<param>`` captures, GET, POST
and DELETE, the query string, JSON bodies in and out, raw bodies in
(a dataset upload), replies streamed with chunked transfer encoding, a
cap on the body size, graceful start and stop. The admin REST service
and the predictor are built on it.

A request's body is read by its ``Content-Type``, as the reference
reads it: JSON for a JSON type or none (a body that does not parse is
400); for ``application/x-www-form-urlencoded`` (curl's ``-d``) JSON
when it parses, else the raw bytes; the raw bytes for any other type,
never sniffed. The raw bytes reach the handler as
``RequestContext.raw_body``. The cap is ``RAFIKI_TPU_MAX_UPLOAD_MB``
(256 MiB by default), read when the server is built unless ``max_body``
is given: a body over it gets 413 before a byte of it is read, and the
connection closes.

Every server observes itself, as the reference's does:

- ``GET /metrics`` (``metrics_route``: Prometheus text of the process
  registry) joins the route table unless the service has its own or
  ``RAFIKI_TPU_METRICS=0``;
- each request is timed into ``rafiki_tpu_http_request_seconds`` and
  counted in ``rafiki_tpu_http_requests_total``, labelled by the
  server's name and the route's pattern (and the status);
- the trace edge: an ``X-Trace-Id`` header is honoured (else a sampled
  trace is minted), bound to the handler's thread
  (``observe.trace.current()``), recorded as the ``http <METHOD>
  <route>`` span and echoed in the reply's ``X-Trace-Id`` header; the
  edge that minted the trace gives its tail verdict
  (``observe.trace.complete``) when the request ends.

Every server is an ``http`` fault site (``faults.site_hook``, resolved
when the server is built): an injected ``error`` answers its code before
the handler runs, and an injected ``timeout`` stalls the request first.

A handler is ``handler(params, body, ctx) -> (status, obj)`` or
``(status, obj, headers)``: ``params`` holds the path's captures,
``body`` the parsed JSON body (None without one) and ``ctx`` the
request's headers, query string and raw body (``RequestContext``). A handler
that takes a single argument is given the body alone. ``obj`` is sent
as JSON, as it is when it is a ``RawResponse`` (the dashboard's HTML),
or streamed when it is a ``StreamResponse``. A handler may
raise ``HttpError`` for a chosen status; a ``PermissionError`` answers
401, or the ``status`` it carries (403 for a caller who is not the
owner); a ``ValueError`` answers 400 and any other exception 500.
"""

from __future__ import annotations

import inspect
import json
import os
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .. import faults
from ..observe import metrics, trace

_log = logging.getLogger(__name__)

Handler = Callable[..., Tuple]


class RequestContext:
    def __init__(self, headers, query: Dict[str, List[str]],
                 raw_body: Optional[bytes] = None):
        self.headers = headers
        self.query = query
        # A body that is not JSON (a dataset upload); None otherwise.
        self.raw_body = raw_body

    @property
    def bearer_token(self) -> Optional[str]:
        h = self.headers.get("Authorization", "")
        if h.startswith("Bearer "):
            return h[len("Bearer "):]
        return None

    def query_one(self, key: str, default: Optional[str] = None,
                  ) -> Optional[str]:
        vals = self.query.get(key)
        return vals[0] if vals else default


class HttpError(Exception):
    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers


class RawResponse:
    """A handler return value sent as it is (Prometheus text, the
    dashboard's HTML), not as JSON."""

    def __init__(self, content_type: str, data):
        self.content_type = content_type
        self.data = data.encode() if isinstance(data, str) else data


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


def _compile(path: str) -> re.Pattern:
    # "/train_jobs/<job_id>/stop" -> ^/train_jobs/(?P<job_id>[^/]+)/stop$
    return re.compile("^" + re.sub(r"<(\w+)>", r"(?P<\1>[^/]+)", path)
                      + "$")


class _Server(ThreadingHTTPServer):
    # The listen backlog: the standard library's 5 resets the
    # connections of a burst of clients before the front can answer
    # them, 429 included.
    request_queue_size = 128


def metrics_route(params, body, ctx):
    """The shared ``GET /metrics`` handler: the process registry in
    Prometheus text format 0.0.4. Exemplars are added only on an
    explicit ``?exemplars=1`` (and with ``RAFIKI_TPU_METRICS_EXEMPLARS``
    on), never on a default scrape."""
    if metrics.exemplars_enabled() and \
            ctx.query_one("exemplars") in ("1", "true"):
        return 200, RawResponse(
            "text/plain; version=0.0.4; charset=utf-8",
            metrics.registry().expose(exemplars=True))
    return 200, RawResponse("text/plain; version=0.0.4; charset=utf-8",
                            metrics.registry().expose())


def _full_handler(handler: Handler) -> Handler:
    """``handler`` as ``(params, body, ctx)``: one that takes a single
    argument is given the body alone."""
    try:
        sig = inspect.signature(handler)
    except (TypeError, ValueError):
        return handler
    positional = [p for p in sig.parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if len(positional) == 1 and not any(
            p.kind == p.VAR_POSITIONAL for p in sig.parameters.values()):
        return lambda params, body, ctx: handler(body)
    return handler


class JsonHttpServer:
    """A route-table HTTP server. ``port=0`` picks a free port."""

    def __init__(self, routes: List[Tuple[str, str, Handler]],
                 host: str = "127.0.0.1", port: int = 0,
                 name: str = "http", max_body: Optional[int] = None):
        routes = list(routes)
        self.name = name
        # Bodies are buffered before dispatch, so one forged
        # Content-Length must not exhaust the process's memory.
        if max_body is None:
            max_body = int(os.environ.get("RAFIKI_TPU_MAX_UPLOAD_MB",
                                          "256")) * 1024 * 1024
        self.max_body = max_body
        self._observe = metrics.metrics_enabled()
        if self._observe and not any(p == "/metrics" for _, p, _ in routes):
            routes.append(("GET", "/metrics", metrics_route))
        # The route's pattern, not the path, labels the series: a path
        # carries ids.
        self._routes = [(method.upper(), path, _compile(path),
                         _full_handler(h)) for method, path, h in routes]
        if self._observe:
            reg = metrics.registry()
            self._http_hist = reg.histogram(
                "rafiki_tpu_http_request_seconds",
                "Request handling latency per service + route pattern")
            self._http_count = reg.counter(
                "rafiki_tpu_http_requests_total",
                "Requests served per service + route pattern + status")
        # None when the fault plane is disarmed.
        self._fault = faults.site_hook("http")
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                _log.debug("%s " + fmt, name, *args)

            def _dispatch(self, method: str):
                parsed = urlparse(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                if length > outer.max_body:
                    # The client is still sending: close rather than
                    # reuse a connection with the unread body in it.
                    self.close_connection = True
                    self._reply(413, {"error": f"request body {length} "
                                      f"bytes exceeds limit "
                                      f"{outer.max_body}"})
                    return
                body = None
                raw_body = None
                if length:
                    raw = self.rfile.read(length)
                    ctype = (self.headers.get("Content-Type") or "").lower()
                    if "json" in ctype or not ctype:
                        try:
                            body = json.loads(raw)
                        except json.JSONDecodeError:
                            self._reply(400, {"error": "invalid JSON body"})
                            return
                    elif "x-www-form-urlencoded" in ctype:
                        # curl -d's type, under which clients often send
                        # JSON: parsed when it parses.
                        try:
                            body = json.loads(raw)
                        except json.JSONDecodeError:
                            raw_body = raw
                    else:
                        # Any other type reaches the handler as bytes,
                        # even a CSV that happens to parse as JSON.
                        raw_body = raw
                ctx = RequestContext(self.headers, parse_qs(parsed.query),
                                     raw_body=raw_body)
                for m, route, pattern, handler in outer._routes:
                    if m != method:
                        continue
                    match = pattern.match(parsed.path)
                    if match is None:
                        continue
                    if outer._fault is not None:
                        act = outer._fault(op=method, route=route)
                        if act is not None and act[0] == "error":
                            self._reply(act[1], {
                                "error": f"injected: http.error "
                                         f"({act[1]})"})
                            return
                    # The trace edge: honour an incoming X-Trace-Id or
                    # mint a sampled trace, bound for the handler so
                    # the batcher and the scatter carry it on.
                    tctx = trace.start_trace(
                        self.headers.get(trace.TRACE_HEADER))
                    wall = time.time()
                    t0 = time.monotonic()
                    headers = None
                    try:
                        with trace.use(tctx):
                            result = handler(match.groupdict(), body, ctx)
                        if len(result) == 3:
                            status, obj, headers = result
                        else:
                            status, obj = result
                    except HttpError as e:
                        status, obj = e.status, {"error": e.message}
                        headers = e.headers
                    except PermissionError as e:
                        status = getattr(e, "status", 401)
                        obj = {"error": str(e)}
                    except ValueError as e:
                        status, obj = 400, {"error": str(e)}
                    except Exception as e:  # the server keeps serving
                        _log.exception("%s %s failed", method, parsed.path)
                        status, obj = 500, {
                            "error": f"{type(e).__name__}: {e}"}
                    dur = time.monotonic() - t0
                    if tctx is not None:
                        trace.record_event(
                            f"http {method} {route}", name, [tctx], wall,
                            dur, attrs={"status": status}, child=False)
                        # The tail verdict: this edge minted the trace,
                        # so its outcome decides what is kept (errors
                        # and slow requests always, the rest sampled).
                        trace.complete(tctx, dur, error=status >= 500)
                        headers = dict(headers or {})
                        headers.setdefault(trace.TRACE_HEADER,
                                           tctx.header_value())
                    if outer._observe:
                        # Observed inside the request's context, so a
                        # bucket's exemplar names its trace, and after
                        # the tail verdict, so it names only a trace
                        # that was kept.
                        with trace.use(tctx):
                            outer._http_hist.observe(dur, service=name,
                                                     route=route)
                        # rta: disable=RTA301 route patterns + status codes are fixed vocabularies; per-instance service= series are removed by their owners (predictor/app.py); the admin's live for the process
                        outer._http_count.inc(service=name, route=route,
                                              code=str(status))
                    self._reply(status, obj, headers)
                    return
                if outer._observe:
                    # rta: disable=RTA301 same service= lifecycle as the routed series above
                    outer._http_count.inc(service=name, route="(none)",
                                          code="404")
                self._reply(404, {"error": f"no route {method} "
                                           f"{parsed.path}"})

            def _reply(self, status: int, obj: Any,
                       headers: Optional[Dict[str, str]] = None):
                if isinstance(obj, StreamResponse):
                    self._reply_stream(status, obj, headers)
                    return
                if isinstance(obj, RawResponse):
                    data, ctype = obj.data, obj.content_type
                else:
                    data, ctype = json.dumps(obj).encode(), "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(data)

            def _reply_stream(self, status: int, obj: StreamResponse,
                              headers: Optional[Dict[str, str]] = None):
                """One HTTP chunk per fragment, flushed at once. A
                broken pipe (client gone) stops the iteration and closes
                the connection; the source iterator is always closed, so
                its ``finally`` blocks run."""
                self.send_response(status)
                self.send_header("Content-Type", obj.content_type)
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
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

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

        self._server = _Server((host, port), _Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "JsonHttpServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"{self.name}-http",
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        # shutdown() waits for serve_forever, so only a started server
        # may be asked; either way the socket closes.
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
