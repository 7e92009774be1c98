"""The port's HTTP plane (``crowdllama_tpu_torch/net/http.py``) against
aiohttp as the oracle.

One ``aiohttp.web`` app and the same app on the port's server (the same
handler code against each module's names) get the same raw bytes over
loopback: keep-alive, chunked and ``Content-Length`` bodies, 413 over
1 MiB, a malformed request line and header, unknown routes and methods,
HTTP/1.0, ``{name}`` matches, query strings, a streamed chunked reply.
Status codes and the headers that matter (Content-Type, Content-Length,
Transfer-Encoding, Allow, whether the connection closes) must be equal,
and the bodies too where they are not error prose.  A client that drops
a stream makes the handler's next write raise on both.  The port's
client reads both servers' replies whole and line by line.
"""

import asyncio

import pytest

aiohttp = pytest.importorskip("aiohttp")
from aiohttp import web as aweb  # noqa: E402

from crowdllama_tpu_torch.net import http as tweb  # noqa: E402

DEADLINE = 50.0
BIG = b"x" * (1024 ** 2 + 10)


def _app(web, seen: dict):
    """The same handlers against either module."""

    @web.middleware
    async def count(request, handler):
        try:
            resp = await handler(request)
            status = resp.status
            return resp
        except web.HTTPException as e:
            status = e.status
            raise
        finally:
            seen.setdefault("statuses", []).append(status)

    async def echo(request):
        body = await request.read()
        return web.json_response({"n": len(body),
                                  "a": request.query.getall("a", []),
                                  "h": request.headers.get("X-Thing", "")})

    async def js(request):
        try:
            body = await request.json()
        except ValueError:
            return web.json_response({"error": "invalid JSON"}, status=400)
        return web.json_response({"got": body}, status=201,
                                 headers={"Retry-After": "3"})

    async def stream(request):
        out = web.StreamResponse(
            status=200, headers={"Content-Type": "application/x-ndjson"})
        await out.prepare(request)
        for i in range(int(request.query.get("n", "3"))):
            await out.write(b'{"i": %d}\n' % i)
        await out.write_eof()
        return out

    async def endless(request):
        out = web.StreamResponse(
            status=200, headers={"Content-Type": "text/event-stream"})
        await out.prepare(request)
        try:
            for i in range(500):
                await out.write(b"data: %d\n\n" % i)
                await asyncio.sleep(0.01)
        except Exception as e:
            seen["disconnect"] = e
            raise
        seen["disconnect"] = None
        return out

    async def item(request):
        return web.json_response({"id": request.match_info["id"]})

    async def text(request):
        return web.Response(text="hello\n", content_type="text/plain")

    async def boom(request):
        raise RuntimeError("handler failed")

    app = web.Application(middlewares=[count])
    app.router.add_post("/echo", echo)
    app.router.add_post("/json", js)
    app.router.add_get("/stream", stream)
    app.router.add_get("/endless", endless)
    app.router.add_get("/item/{id}", item)
    app.router.add_get("/text", text)
    app.router.add_get("/boom", boom)
    app.router.add_route("*", "/any", text)
    return app


def _req(line: str, body: bytes = b"", close: bool = True, **headers):
    head = [line, "Host: t"] + [f"{k.replace('_', '-')}: {v}"
                                for k, v in headers.items()]
    if close:
        head.append("Connection: close")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _chunked(*parts: bytes) -> bytes:
    return b"".join(b"%x\r\n%s\r\n" % (len(p), p) for p in parts) \
        + b"0\r\n\r\n"


CASES = {
    "content_length": _req("POST /echo HTTP/1.1", b"abc",
                           Content_Length=3),
    "chunked_body": _req("POST /echo HTTP/1.1", _chunked(b"abc", b"de"),
                         Transfer_Encoding="chunked"),
    "keep_alive_two": _req("POST /echo?a=1&a=2 HTTP/1.1", b"ab",
                           close=False, Content_Length=2, X_Thing="yes")
    + _req("GET /item/7 HTTP/1.1"),
    "over_1mib": _req("POST /echo HTTP/1.1", BIG, Content_Length=len(BIG)),
    "over_1mib_chunked": _req("POST /echo HTTP/1.1", _chunked(BIG),
                              Transfer_Encoding="chunked"),
    "json_ok": _req("POST /json HTTP/1.1", b'{"k": [1, 2]}',
                    Content_Length=13),
    "json_bad": _req("POST /json HTTP/1.1", b"{nope", Content_Length=5),
    "malformed_request_line": b"GARBAGE\r\n\r\n",
    "bad_version": b"GET /text HTTP/9\r\n\r\n",
    "malformed_header": b"GET /text HTTP/1.1\r\nHost t\r\n\r\n",
    "unknown_route": _req("GET /nope HTTP/1.1"),
    "unknown_method": _req("GET /echo HTTP/1.1"),
    "any_method": _req("DELETE /any HTTP/1.1"),
    "http10": b"GET /item/42 HTTP/1.0\r\n\r\n",
    "match_info_quoted": _req("GET /item/a%20b HTTP/1.1"),
    "stream_chunked": _req("GET /stream?n=4 HTTP/1.1"),
    "text": _req("GET /text HTTP/1.1"),
    "head": _req("HEAD /text HTTP/1.1"),
    "handler_error": _req("GET /boom HTTP/1.1"),
}
ERROR_PROSE = {"malformed_request_line", "bad_version", "malformed_header"}
HEADERS = ("content-type", "content-length", "transfer-encoding", "allow",
           "retry-after")


def _parse(buf: bytes) -> list[dict]:
    """Every response in ``buf``: status, version, the headers that
    matter, the decoded body, and whether it announces a close."""
    out = []
    while buf:
        head, _, rest = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        version, status = lines[0].split(" ")[:2]
        hdrs = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            hdrs[k.strip().lower()] = v.strip()
        if hdrs.get("transfer-encoding") == "chunked":
            body = b""
            while True:
                size, _, rest = rest.partition(b"\r\n")
                n = int(size, 16)
                body += rest[:n]
                rest = rest[n + 2:]
                if n == 0:
                    break
        else:
            n = int(hdrs.get("content-length", len(rest)))
            body, rest = rest[:n], rest[n:]
        out.append({"version": version, "status": int(status),
                    "headers": {k: hdrs.get(k) for k in HEADERS},
                    "close": hdrs.get("connection", "") == "close"
                    or version == "HTTP/1.0",
                    "body": body})
        buf = rest
    return out


async def _raw(port: int, data: bytes) -> bytes:
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(data)
    await w.drain()
    buf = b""
    try:
        while True:
            piece = await asyncio.wait_for(r.read(1 << 20), 5.0)
            if not piece:
                break
            buf += piece
    finally:
        w.close()
    return buf


async def _drop_mid_stream(port: int) -> None:
    """Read the head and the first event of /endless, then close."""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(_req("GET /endless HTTP/1.1"))
    await w.drain()
    await r.readuntil(b"data: 0")
    w.close()


async def _client_reads(port: int) -> dict:
    base = f"http://127.0.0.1:{port}"
    out = {}
    async with tweb.request("POST", f"{base}/json", json={"k": 1},
                            headers={"X-Thing": "v"}) as resp:
        out["json"] = (resp.status, resp.headers.get("Retry-After"),
                       await resp.json())
    async with tweb.request("GET", f"{base}/stream?n=5") as resp:
        out["lines"] = [line async for line in resp.lines()]
    async with tweb.request("GET", f"{base}/text") as resp:
        out["text"] = (resp.status, await resp.text())
    async with tweb.request("GET", f"{base}/nope") as resp:
        out["404"] = (resp.status, await resp.text())
    return out


async def _run() -> dict:
    seen_a: dict = {}
    seen_t: dict = {}
    runner = aweb.AppRunner(_app(aweb, seen_a), access_log=None)
    await runner.setup()
    await aweb.TCPSite(runner, "127.0.0.1", 0).start()
    server = tweb.Server(_app(tweb, seen_t))
    await server.start()
    ports = {"aiohttp": runner.addresses[0][1], "port": server.port}
    out: dict = {"raw": {}, "client": {}, "seen": {"aiohttp": seen_a,
                                                    "port": seen_t}}
    try:
        for name, data in CASES.items():
            out["raw"][name] = {k: _parse(await _raw(p, data))
                                for k, p in ports.items()}
        for k, p in ports.items():
            await _drop_mid_stream(p)
            out["client"][k] = await _client_reads(p)
        for seen in (seen_a, seen_t):
            for _ in range(200):
                if "disconnect" in seen:
                    break
                await asyncio.sleep(0.02)
    finally:
        await server.stop()
        await runner.cleanup()
    return out


@pytest.fixture(scope="module")
def served():
    return asyncio.run(asyncio.wait_for(_run(), DEADLINE))


@pytest.mark.parametrize("name", sorted(CASES))
def test_raw_requests_answer_as_aiohttp(served, name):
    got = served["raw"][name]["port"]
    want = served["raw"][name]["aiohttp"]
    assert [r["status"] for r in got] == [r["status"] for r in want]
    for g, w in zip(got, want):
        if name in ERROR_PROSE:  # the 400's prose (and so its length)
            g, w = ({**r, "headers": {**r["headers"], "content-length": 0}}
                    for r in (g, w))
        assert g["headers"] == w["headers"], name
        assert g["close"] == w["close"], name
        assert g["version"] == w["version"], name
        if name not in ERROR_PROSE:
            assert g["body"] == w["body"], name


def test_expected_statuses(served):
    status = {n: [r["status"] for r in v["port"]]
              for n, v in served["raw"].items()}
    assert status["keep_alive_two"] == [200, 200]
    assert status["over_1mib"] == status["over_1mib_chunked"] == [413]
    assert status["malformed_request_line"] == [400]
    assert status["malformed_header"] == [400]
    assert status["unknown_route"] == [404]
    assert status["unknown_method"] == [405]
    assert status["handler_error"] == [500]
    first = served["raw"]["keep_alive_two"]["port"][0]
    assert first["body"] == b'{"n": 2, "a": ["1", "2"], "h": "yes"}'
    assert not first["close"]


def test_middleware_sees_router_statuses(served):
    a = served["seen"]["aiohttp"]["statuses"]
    t = served["seen"]["port"]["statuses"]
    assert sorted(t) == sorted(a)
    assert {404, 405, 413} <= set(t)


@pytest.mark.parametrize("server", ["aiohttp", "port"])
def test_client_drop_reaches_the_handler(served, server):
    err = served["seen"][server]["disconnect"]
    assert isinstance(err, ConnectionResetError), err


@pytest.mark.parametrize("server", ["aiohttp", "port"])
def test_port_client_reads_both_servers(served, server):
    c = served["client"][server]
    assert c["json"] == (201, "3", {"got": {"k": 1}})
    assert c["lines"] == [b'{"i": %d}\n' % i for i in range(5)]
    assert c["text"] == (200, "hello\n")
    assert c["404"] == (404, "404: Not Found")
