"""A small HTTP/1.1 server and client on asyncio streams.

The JAX package's gateway and worker obs listener are ``aiohttp.web``
applications; the card machine has no ``aiohttp``, so the port carries
this module in its place, with the surface those two use, under
aiohttp's names so the gateways read side by side:

- *server*: :class:`Application` (a :class:`Router` of method + path
  routes, ``{name}`` segments into ``request.match_info``, and
  ``middlewares`` wrapping every handler, the router's 404 / 405
  included), :class:`Request` (``method``, ``path``, ``query``,
  ``headers``, ``match_info``, ``read()``, ``json()``, ``text()``),
  :class:`Response` / :func:`json_response`, :class:`StreamResponse`
  (``prepare`` / ``write`` / ``write_eof``, chunked) and
  :class:`HTTPException` (raised or returned, it answers with its
  status).  :class:`Server` serves an application on a TCP port.
- *bodies*: ``Content-Length`` and chunked.  A body over
  ``client_max_size`` (1 MiB, aiohttp's default) answers 413 when the
  handler reads it, as aiohttp does.
- *connections*: HTTP/1.1 keep-alive (``Connection: close`` and
  HTTP/1.0 close).  A malformed request line or header answers 400 and
  closes.  A client that drops mid-stream makes the next
  ``StreamResponse.write`` raise ``ConnectionResetError``, as aiohttp's
  does.
- *client*: :func:`request`, one connection per request, a JSON body,
  the reply read whole or line by line as it streams (the CLI's
  gateway commands).
"""

from __future__ import annotations

import asyncio
import email.utils
import http
import json as _json
import logging
import re
import sys
import urllib.parse
from typing import Any, Awaitable, Callable, Iterable

log = logging.getLogger("crowdllama.torch.http")

CLIENT_MAX_SIZE = 1024 ** 2  # aiohttp's default client_max_size
MAX_LINE = 8190  # aiohttp's max_line_size / max_field_size
MAX_HEADERS = 128
KEEPALIVE_S = 75.0  # aiohttp's keepalive_timeout
SERVER = (f"Python/{sys.version_info[0]}.{sys.version_info[1]} "
          "crowdllama-tpu-torch")
_TOKEN = re.compile(r"^[!#$%&'*+\-.^_`|~0-9A-Za-z]+$")

Handler = Callable[["Request"], Awaitable["StreamResponse"]]


def _reason(status: int) -> str:
    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return ""


class Headers:
    """Case-insensitive header map keeping the first spelling seen."""

    def __init__(self, items: Iterable[tuple[str, str]] = ()) -> None:
        self._d: dict[str, tuple[str, str]] = {}
        for k, v in items:
            self[k] = v

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __setitem__(self, key: str, value: str) -> None:
        self._d[key.lower()] = (key, str(value))

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and key.lower() in self._d

    def get(self, key: str, default: Any = None) -> Any:
        item = self._d.get(key.lower())
        return default if item is None else item[1]

    def setdefault(self, key: str, value: str) -> str:
        if key not in self:
            self[key] = value
        return self[key]

    def items(self) -> list[tuple[str, str]]:
        return list(self._d.values())



class Query:
    """The query string's parameters: ``get`` (first value) and
    ``getall`` (every value), as aiohttp's ``MultiDict``."""

    def __init__(self, raw: str) -> None:
        self._pairs = urllib.parse.parse_qsl(raw, keep_blank_values=True)

    def get(self, key: str, default: Any = None) -> Any:
        for k, v in self._pairs:
            if k == key:
                return v
        return default

    def getall(self, key: str, default: Any = None) -> list[str]:
        vals = [v for k, v in self._pairs if k == key]
        if not vals and default is not None:
            return default
        if not vals:
            raise KeyError(key)
        return vals


# ------------------------------------------------------------- responses


class StreamResponse:
    """A response whose body is written piece by piece after ``prepare``:
    chunked on HTTP/1.1 unless ``Content-Length`` is set."""

    def __init__(self, status: int = 200, reason: str | None = None,
                 headers: dict | None = None) -> None:
        self.status = int(status)
        self.reason = reason or _reason(self.status)
        self.headers = Headers((headers or {}).items())
        self._writer: asyncio.StreamWriter | None = None
        self._request: Request | None = None
        self._chunked = False
        self._eof = False

    @property
    def prepared(self) -> bool:
        return self._writer is not None

    def _head(self, keep_alive: bool) -> bytes:
        h = self.headers
        h.setdefault("Date", email.utils.formatdate(usegmt=True))
        h.setdefault("Server", SERVER)
        req = self._request
        if "Content-Length" not in h and req.method != "HEAD":
            if req.version >= (1, 1):
                self._chunked = True
                h["Transfer-Encoding"] = "chunked"
            else:
                keep_alive = req.keep_alive = False
        # The HTTP/1.1 default is keep-alive, HTTP/1.0's close: only the
        # exception is spelled out, as aiohttp does.
        if req.version >= (1, 1) and not keep_alive:
            h["Connection"] = "close"
        elif req.version < (1, 1) and keep_alive:
            h["Connection"] = "keep-alive"
        lines = [f"HTTP/{req.version[0]}.{req.version[1]} {self.status} "
                 f"{self.reason}"]
        lines += [f"{k}: {v}" for k, v in h.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def prepare(self, request: "Request") -> None:
        """Send the status line and headers."""
        if self._writer is not None:
            return
        self._request = request
        self._writer = request._writer
        self._check_open()
        self._writer.write(self._head(request.keep_alive))
        request._response = self
        await self._drain()

    def _check_open(self) -> None:
        w, r = self._writer, self._request
        if (w is None or w.is_closing()
                or (r is not None and r._reader.at_eof())):
            raise ConnectionResetError("Cannot write to closing transport")

    async def _drain(self) -> None:
        try:
            await self._writer.drain()
        except (ConnectionError, OSError) as e:
            raise ConnectionResetError(
                "Cannot write to closing transport") from e

    async def write(self, data: bytes) -> None:
        """One piece of the body (one chunk on a chunked response)."""
        if self._writer is None:
            raise RuntimeError("Cannot call write() before prepare()")
        if self._eof:
            raise RuntimeError("Cannot call write() after write_eof()")
        if not data or self._request.method == "HEAD":
            return
        self._check_open()
        if self._chunked:
            self._writer.write(b"%x\r\n" % len(data) + data + b"\r\n")
        else:
            self._writer.write(data)
        await self._drain()

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof:
            return
        if data:
            await self.write(data)
        self._eof = True
        if self._chunked:
            self._check_open()
            self._writer.write(b"0\r\n\r\n")
            await self._drain()


class Response(StreamResponse):
    """A response with its whole body known up front."""

    def __init__(self, *, status: int = 200, reason: str | None = None,
                 body: bytes | None = None, text: str | None = None,
                 headers: dict | None = None,
                 content_type: str | None = None) -> None:
        super().__init__(status=status, reason=reason, headers=headers)
        if text is not None:
            if body is not None:
                raise ValueError("body and text are not allowed together")
            ctype = content_type or "text/plain"
            self.headers.setdefault("Content-Type",
                                    f"{ctype}; charset=utf-8")
            body = text.encode("utf-8")
        elif content_type is not None:
            self.headers.setdefault("Content-Type", content_type)
        self.body = body or b""

    async def prepare(self, request: "Request") -> None:
        if self._writer is not None:
            return
        self.headers["Content-Length"] = str(len(self.body))
        await super().prepare(request)
        if self.body and request.method != "HEAD":
            self._writer.write(self.body)
            await self._drain()
        self._eof = True


def json_response(data: Any = None, *, status: int = 200,
                  reason: str | None = None, headers: dict | None = None,
                  dumps: Callable[[Any], str] = _json.dumps) -> Response:
    return Response(text=dumps(data), status=status, reason=reason,
                    headers=headers, content_type="application/json")


class HTTPException(Response, Exception):
    """An HTTP status as an exception: raised from a handler (or the
    router), it is the response."""

    status_code = 500

    def __init__(self, *, headers: dict | None = None,
                 reason: str | None = None, text: str | None = None,
                 content_type: str | None = None) -> None:
        status = self.status_code
        if text is None:
            text = f"{status}: {reason or _reason(status)}"
        Response.__init__(self, status=status, reason=reason, text=text,
                          headers=headers, content_type=content_type)
        Exception.__init__(self, text)

    def __hash__(self) -> int:
        return id(self)


class HTTPNotFound(HTTPException):
    status_code = 404


class HTTPMethodNotAllowed(HTTPException):
    status_code = 405

    def __init__(self, method: str, allowed_methods: Iterable[str],
                 **kw) -> None:
        allow = ",".join(sorted(allowed_methods))
        super().__init__(headers={"Allow": allow}, **kw)
        self.method = method.upper()
        self.allowed_methods = set(allowed_methods)


class HTTPRequestEntityTooLarge(HTTPException):
    status_code = 413

    def __init__(self, max_size: int, actual_size: int, **kw) -> None:
        super().__init__(text=f"Maximum request body size {max_size} "
                              f"exceeded, actual body size {actual_size}",
                         **kw)


class HTTPInternalServerError(HTTPException):
    status_code = 500


# --------------------------------------------------------------- request


class Request:
    """One parsed request; its body was read by the server (up to one byte
    past ``client_max_size``)."""

    def __init__(self, method: str, target: str, version: tuple[int, int],
                 headers: Headers, body: bytes, body_size: int,
                 reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 client_max_size: int) -> None:
        self.method = method
        self.version = version
        self.headers = headers
        self.raw_path = target
        split = urllib.parse.urlsplit(target)
        self.path = urllib.parse.unquote(split.path)
        self.query_string = split.query
        self.query = Query(split.query)
        self.match_info: dict[str, str] = {}
        self._body = body
        self._body_size = body_size
        self._client_max_size = client_max_size
        self._reader = reader
        self._writer = writer
        self._response: StreamResponse | None = None
        conn = headers.get("Connection", "").lower()
        self.keep_alive = (conn != "close" if version >= (1, 1)
                           else conn == "keep-alive")

    async def read(self) -> bytes:
        if self._body_size > self._client_max_size:
            raise HTTPRequestEntityTooLarge(self._client_max_size,
                                            self._body_size)
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self) -> Any:
        return _json.loads(await self.text())


# ---------------------------------------------------------------- router


def middleware(fn):
    """Marks a middleware, as ``aiohttp.web.middleware`` does (every
    middleware here is new-style: ``(request, handler)``)."""
    fn.__middleware_version__ = 1
    return fn


class Route:
    def __init__(self, method: str, canonical: str, handler: Handler) -> None:
        self.method = method
        self.canonical = canonical
        self.handler = handler
        names = re.findall(r"\{([^{}/]+)\}", canonical)
        pattern = re.sub(r"\\\{[^{}/]+\\\}", "([^{}/]+)",
                         re.escape(canonical))
        self._names = names
        self._re = re.compile(f"^{pattern}$")

    def match(self, path: str) -> dict[str, str] | None:
        m = self._re.match(path)
        if m is None:
            return None
        return dict(zip(self._names, m.groups()))


class Router:
    def __init__(self) -> None:
        self._routes: list[Route] = []

    def add_route(self, method: str, path: str, handler: Handler) -> Route:
        route = Route(method.upper(), path, handler)
        self._routes.append(route)
        return route

    def add_get(self, path: str, handler: Handler,
                allow_head: bool = True) -> Route:
        if allow_head:
            self.add_route("HEAD", path, handler)
        return self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> Route:
        return self.add_route("POST", path, handler)

    def routes(self) -> list[Route]:
        return list(self._routes)

    def resolve(self, method: str, path: str
                ) -> tuple[Handler, dict[str, str]]:
        """The handler for ``method path`` and its match info; a handler
        that raises 404 or 405 when nothing matches."""
        allowed: set[str] = set()
        for route in self._routes:
            info = route.match(path)
            if info is None:
                continue
            if route.method in ("*", method):
                return route.handler, info
            allowed.add(route.method)
        if allowed:
            async def not_allowed(request: Request):
                raise HTTPMethodNotAllowed(method, allowed)
            return not_allowed, {}

        async def not_found(request: Request):
            raise HTTPNotFound()
        return not_found, {}


class Application:
    def __init__(self, middlewares: Iterable = (),
                 client_max_size: int = CLIENT_MAX_SIZE) -> None:
        self.router = Router()
        self.middlewares = list(middlewares)
        self.client_max_size = client_max_size

    async def handle(self, request: Request) -> StreamResponse:
        handler, request.match_info = self.router.resolve(
            request.method, request.path)
        for mw in reversed(self.middlewares):
            handler = _bind(mw, handler)
        return await handler(request)


def _bind(mw, handler: Handler) -> Handler:
    async def call(request: Request) -> StreamResponse:
        return await mw(request, handler)
    return call


# ---------------------------------------------------------------- server


class _BadRequest(Exception):
    pass


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        line = await reader.readuntil(b"\n")
    except asyncio.LimitOverrunError as e:
        raise _BadRequest(f"Got more than {MAX_LINE} bytes when reading "
                          "a line") from e
    if len(line) > MAX_LINE + 2:
        raise _BadRequest(f"Got more than {MAX_LINE} bytes when reading "
                          "a line")
    return line.rstrip(b"\r\n")


async def _read_headers(reader: asyncio.StreamReader) -> Headers:
    headers = Headers()
    for _ in range(MAX_HEADERS + 1):
        line = await _read_line(reader)
        if not line:
            return headers
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep or not _TOKEN.match(name):
            raise _BadRequest(f"Invalid header: {line[:64]!r}")
        value = value.strip()
        if name in headers and name.lower() not in ("content-length",
                                                    "transfer-encoding"):
            headers[name] = f"{headers[name]},{value}"
        elif name in headers:
            raise _BadRequest(f"Duplicate {name} header")
        else:
            headers[name] = value
    raise _BadRequest("Too many headers")


async def _read_body(reader: asyncio.StreamReader, headers: Headers,
                     limit: int) -> tuple[bytes, int, bool]:
    """(body, its size, whole) with at most ``limit + 1`` bytes kept: a
    body over the limit is read only that far, and ``whole`` says the
    connection can be reused."""
    te = headers.get("Transfer-Encoding", "").lower()
    if te:
        if te != "chunked":
            raise _BadRequest(f"Unsupported Transfer-Encoding {te!r}")
        parts, size = [], 0
        while True:
            line = await _read_line(reader)
            try:
                n = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError as e:
                raise _BadRequest(f"Invalid chunk size {line[:32]!r}") from e
            if n < 0:
                raise _BadRequest("Negative chunk size")
            if n == 0:
                while await _read_line(reader):  # trailers
                    pass
                return b"".join(parts), size, True
            if size + n > limit:
                # Keep reading this chunk only as far as the limit.
                parts.append(await reader.readexactly(limit + 1 - size))
                return b"".join(parts), size + n, False
            parts.append(await reader.readexactly(n))
            size += n
            if await reader.readexactly(2) != b"\r\n":
                raise _BadRequest("Chunk without its CRLF")
    cl = headers.get("Content-Length")
    if cl is None:
        return b"", 0, True
    if not cl.isdigit():
        raise _BadRequest(f"Invalid Content-Length {cl!r}")
    n = int(cl)
    if n > limit:
        return await reader.readexactly(limit + 1), n, False
    return await reader.readexactly(n), n, True


class Server:
    """Serves an :class:`Application` on ``host:port`` (0 = ephemeral;
    ``port`` holds the bound one after ``start``)."""

    def __init__(self, app: Application, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.app = app
        self.host = host
        self.port = port
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port, limit=MAX_LINE + 2)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while await self._serve_one(reader, writer):
                pass
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.TimeoutError):
            pass
        except asyncio.CancelledError:
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    async def _serve_one(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> bool:
        """One request; False closes the connection."""
        try:
            line = await asyncio.wait_for(_read_line(reader), KEEPALIVE_S)
        except asyncio.IncompleteReadError:
            return False
        except _BadRequest as e:
            await _bad_request(writer, str(e))
            return False
        if not line:
            return True  # a stray CRLF between requests
        try:
            parts = line.decode("latin-1").split(" ")
            if len(parts) != 3:
                raise _BadRequest(f"Bad status line {line[:64]!r}")
            method, target, ver = parts
            m = re.match(r"^HTTP/(\d)\.(\d)$", ver)
            if m is None or not _TOKEN.match(method) or not target:
                raise _BadRequest(f"Bad status line {line[:64]!r}")
            version = (int(m.group(1)), int(m.group(2)))
            headers = await _read_headers(reader)
            body, size, whole = await _read_body(
                reader, headers, self.app.client_max_size)
        except _BadRequest as e:
            await _bad_request(writer, str(e))
            return False
        request = Request(method, target, version, headers, body, size,
                          reader, writer, self.app.client_max_size)
        if not whole:
            request.keep_alive = False
        try:
            resp = await self.app.handle(request)
        except HTTPException as e:
            resp = e
        except (asyncio.CancelledError, ConnectionError):
            raise
        except Exception:
            log.exception("error handling %s %s", method, request.path)
            resp = HTTPInternalServerError(
                text="500 Internal Server Error\n\n"
                     "Server got itself in trouble")
        if request._response is not None and request._response is not resp:
            # A streamed response went out and the handler returned
            # another object: the started one is what the client holds.
            resp = request._response
        if not resp.prepared:
            await resp.prepare(request)
        if not resp._eof:
            await resp.write_eof()
        await writer.drain()
        return request.keep_alive and not writer.is_closing()


async def _bad_request(writer: asyncio.StreamWriter, message: str) -> None:
    body = f"400, message:\n  {message}".encode()
    head = (f"HTTP/1.0 400 Bad Request\r\nContent-Type: text/plain; "
            f"charset=utf-8\r\nContent-Length: {len(body)}\r\n"
            f"Date: {email.utils.formatdate(usegmt=True)}\r\n"
            f"Server: {SERVER}\r\n\r\n").encode()
    try:
        writer.write(head + body)
        await writer.drain()
    except (ConnectionError, OSError):
        pass


# ---------------------------------------------------------------- client


class ClientError(Exception):
    """A reply the client cannot parse."""


class ClientResponse:
    """A reply being read: ``status``, ``headers``, then the body whole
    (``read`` / ``text`` / ``json``) or line by line (``lines``)."""

    def __init__(self, status: int, reason: str, headers: Headers,
                 reader: asyncio.StreamReader) -> None:
        self.status = status
        self.reason = reason
        self.headers = headers
        self._reader = reader
        te = headers.get("Transfer-Encoding", "").lower()
        self._chunked = te == "chunked"
        cl = headers.get("Content-Length")
        self._left = int(cl) if cl is not None and cl.isdigit() else None
        self._done = False

    async def _piece(self) -> bytes:
        """The next piece of the body, b"" at its end."""
        if self._done:
            return b""
        r = self._reader
        if self._chunked:
            line = await _read_line(r)
            n = int(line.split(b";", 1)[0].strip() or b"0", 16)
            if n == 0:
                while await _read_line(r):
                    pass
                self._done = True
                return b""
            data = await r.readexactly(n)
            await r.readexactly(2)
            return data
        if self._left is not None:
            if self._left == 0:
                self._done = True
                return b""
            data = await r.read(min(self._left, 65536))
            if not data:
                raise ClientError("connection closed mid-body")
            self._left -= len(data)
            return data
        data = await r.read(65536)
        if not data:
            self._done = True
        return data

    async def read(self) -> bytes:
        parts = []
        while True:
            piece = await self._piece()
            if not piece:
                return b"".join(parts)
            parts.append(piece)

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self) -> Any:
        return _json.loads(await self.text())

    async def lines(self):
        """The body's lines as they arrive (each with its ``\\n``)."""
        buf = b""
        while True:
            piece = await self._piece()
            if not piece:
                break
            buf += piece
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                yield line + b"\n"
        if buf:
            yield buf


class _Request:
    def __init__(self, method: str, url: str, json: Any, headers: dict,
                 timeout: float) -> None:
        self.method, self.url, self.timeout = method.upper(), url, timeout
        self.json, self.headers = json, headers
        self._writer: asyncio.StreamWriter | None = None

    async def __aenter__(self) -> ClientResponse:
        u = urllib.parse.urlsplit(self.url)
        if u.scheme != "http":
            raise ClientError(f"only http:// URLs are served: {self.url}")
        port = u.port or 80
        target = (u.path or "/") + (f"?{u.query}" if u.query else "")
        body = b"" if self.json is None else _json.dumps(self.json).encode()
        head = Headers({"Host": f"{u.hostname}:{port}",
                        "Connection": "close",
                        "Content-Length": str(len(body))}.items())
        if self.json is not None:
            head["Content-Type"] = "application/json"
        for k, v in self.headers.items():
            head[k] = v
        reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(u.hostname, port, limit=1 << 24),
            self.timeout)
        lines = [f"{self.method} {target} HTTP/1.1"]
        lines += [f"{k}: {v}" for k, v in head.items()]
        self._writer.write(("\r\n".join(lines) + "\r\n\r\n").encode()
                           + body)
        await self._writer.drain()
        status_line = await asyncio.wait_for(_read_line(reader),
                                             self.timeout)
        parts = status_line.decode("latin-1").split(" ", 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise ClientError(f"bad status line {status_line[:64]!r}")
        headers = await _read_headers(reader)
        return ClientResponse(int(parts[1]), parts[2] if len(parts) > 2
                              else "", headers, reader)

    async def __aexit__(self, *exc) -> None:
        if self._writer is not None:
            self._writer.close()


def request(method: str, url: str, json: Any = None,
            headers: dict | None = None,
            timeout: float = 30.0) -> _Request:
    """``async with request("POST", url, json=...) as resp:`` — one
    connection for one exchange, closed on leaving the block.
    ``timeout`` bounds the connect and the reply's head."""
    return _Request(method, url, json, headers or {}, timeout)
