"""Network emulation for tests and benchmarks: an injected-latency relay.

Counterpart of ``crowdllama_tpu/testing/netem.py``.  :class:`DelayProxy`
is a transparent TCP relay that delivers every chunk a fixed one-way
delay after it was read.  It is deliberately dumb: no bandwidth shaping,
no loss, no reordering, so an injected RTT is the one variable a sweep
changes.
"""

from __future__ import annotations

import asyncio


class DelayProxy:
    """Transparent TCP relay that delivers every chunk ``delay_s`` after it
    was read, per direction (injected RTT = 2 * delay_s per round trip).

    Delivery is timestamp-scheduled (reader task enqueues, writer task
    sleeps until due), so reads never stall behind the sleep: a multi-chunk
    message pays the delay ONCE, not once per chunk."""

    def __init__(self, target_port: int, delay_s: float,
                 host: str = "127.0.0.1"):
        self._target = target_port
        self._delay = delay_s
        self._host = host
        self._server: asyncio.base_events.Server | None = None
        self._tasks: set[asyncio.Task] = set()
        self._writers: list[asyncio.StreamWriter] = []

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._on_conn, self._host, 0)
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        # Pumps and their transports go first: on Python 3.12
        # Server.wait_closed() waits for every connection it accepted.
        if self._server is not None:
            self._server.close()
        for t in list(self._tasks):
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        for w in self._writers:
            w.close()
        if self._server is not None:
            await self._server.wait_closed()

    def _track(self, coro) -> None:
        t = asyncio.create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def _on_conn(self, reader, writer):
        try:
            up_r, up_w = await asyncio.open_connection(
                self._host, self._target)
        except OSError:
            writer.close()
            return
        self._writers += [writer, up_w]
        self._track(self._pump(reader, up_w))
        self._track(self._pump(up_r, writer))

    async def _pump(self, reader, writer):
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        async def drain_delayed():
            while True:
                item = await q.get()
                if item is None:
                    break
                due, data = item
                dt = due - loop.time()
                if dt > 0:
                    await asyncio.sleep(dt)
                try:
                    writer.write(data)
                    await writer.drain()
                except (ConnectionError, OSError):
                    return
            try:
                if writer.can_write_eof():
                    writer.write_eof()  # propagate half-close
            except (ConnectionError, OSError):
                pass

        w = asyncio.create_task(drain_delayed())
        try:
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                q.put_nowait((loop.time() + self._delay, chunk))
        except (ConnectionError, OSError):
            pass
        finally:
            q.put_nowait(None)
            try:
                await w
            except asyncio.CancelledError:
                w.cancel()
                raise
