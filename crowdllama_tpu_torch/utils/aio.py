"""Asyncio helpers shared across background services (counterpart of
``crowdllama_tpu/utils/aio.py``)."""

from __future__ import annotations

import asyncio
import inspect
import logging
import random
from typing import Callable

#: Default tick jitter fraction for swarm background loops: every peer
#: runs the same cadences, and without phase jitter the ticks of a fleet
#: started together synchronize into bursts of handshakes.
DEFAULT_JITTER = 0.25


async def run_every(interval: float, fn: Callable, log: logging.Logger,
                    level: int = logging.ERROR,
                    jitter: float = DEFAULT_JITTER) -> None:
    """Run ``fn`` (sync or async) every ``interval`` seconds forever.

    Errors are logged at ``level`` and never kill the loop; cancellation
    propagates.  ``jitter``: the first tick waits a random fraction of the
    interval and every sleep is scaled by a per-tick uniform factor in
    [1 - jitter, 1 + jitter]; 0 keeps a strict cadence.
    """
    if jitter:
        await asyncio.sleep(random.random() * interval * jitter)
    while True:
        try:
            result = fn()
            if inspect.isawaitable(result):
                await result
        except asyncio.CancelledError:
            raise
        except Exception:
            log.log(level, "background loop error (%s)",
                    getattr(fn, "__name__", fn),
                    exc_info=level >= logging.ERROR)
        sleep = interval
        if jitter:
            sleep *= 1 + jitter * (2 * random.random() - 1)
        await asyncio.sleep(sleep)
