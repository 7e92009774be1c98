"""Captured megastep flights: one CUDA graph per decode megastep shape.

The port's counterpart of the program cache ``jit`` gives the JAX
package (no JAX module matches it).  A :class:`MegastepGraph` captures a
runner's K-step decode megastep (``ops/megastep.py``: the forward with
its attention kernels, the repeat penalty, sampling and the done-flags)
once, and each flight then copies its inputs into the graph's static
buffers and replays it: one graph launch in place of the ~700-1,000
eager launches a step costs the host.

- **Static inputs**: the noise ``[K, B, W]`` (the sampled graph only;
  the greedy graph takes none, as the eager step does), ``eos_ids`` and
  ``budgets`` ``[B]``, and the runner's page table at full width (kernel
  B's split plan depends on the width and the page alone, so it is fixed
  for the graph).  **Static outputs**: tokens and done ``[K, B]``, copied
  out after every replay (the scheduler reads a flight back after the
  next one is dispatched).
- **Addresses**: the graph holds the addresses of the state's tensors
  and of the split-KV scratch (``ops/cuda/paged.py split_scratch``).
  Before every replay :meth:`GraphCache.graph` compares them with the
  captured ones and captures anew when they differ: a graph never
  replays against tensors other than those it was captured on.  Runners
  keep the captured state and zero it in place on ``init_state`` once a
  graph exists, so the scheduler's state is the warm-up's.
- **Before capture** the body runs once eagerly with every budget at 0:
  every step masked, the state unchanged.  It sizes the split scratch
  (and anything else made on first use) outside the graph's memory pool
  and leaves the split counters at zero.
- **Launch counts**: the kernel wrappers count in Python.  Capture
  records each count's change, puts the counts back, and every replay
  adds that change, so the counts follow the kernels the card runs.
- **Capture** is ``capture_error_mode="thread_local"`` on the calling
  thread (the scheduler's dispatch thread: the event loop and the IPC and
  peer threads keep running) and replay is on that thread's current
  stream.  A failed capture or replay raises; there is no eager fallback
  on CUDA.
"""

from __future__ import annotations

import dataclasses
import time

import torch


def launch_counters() -> list[tuple[object, str]]:
    """Every kernel wrapper's launch counts: (wrapper, attribute)."""
    from crowdllama_tpu_torch.ops.cuda.flash import (
        flash_decode_attention,
        flash_prefill_attention,
    )
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention,
        flash_paged_decode_attention_tp,
        flash_ragged_chunk_attention,
        ragged_paged_attention,
    )

    out = [(flash_prefill_attention, "launches"),
           (flash_decode_attention, "launches")]
    for fn in (flash_paged_decode_attention, flash_paged_decode_attention_tp,
               flash_ragged_chunk_attention, ragged_paged_attention):
        out += [(fn, "launches"), (fn, "launches_int8")]
    return out


def state_tensors(state) -> list[torch.Tensor]:
    """Every device tensor a decode state holds, per-rank lists
    flattened, in field order."""
    out: list[torch.Tensor] = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, list):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


def _scratch(device: torch.device) -> list[torch.Tensor]:
    from crowdllama_tpu_torch.ops.cuda.paged import _SPLIT_SCRATCH

    return list(_SPLIT_SCRATCH.get(device, ()))


def cuda_capture(fn):
    """Capture ``fn()`` in a ``torch.cuda.CUDAGraph``; returns (replay,
    fn's outputs, the bytes the graph's memory pool reserved)."""
    g = torch.cuda.CUDAGraph()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        out = fn()
    return g.replay, out, torch.cuda.memory_reserved() - before


class MegastepGraph:
    """One captured decode megastep over ``state``.

    ``body(inputs)`` runs the K-step flight on ``state`` (in place) with
    the static ``inputs`` (name -> tensor) and returns its (tokens, done);
    ``capture`` is :func:`cuda_capture`, or a stand-in with its contract."""

    def __init__(self, body, state, inputs: dict, capture=cuda_capture):
        self.inputs = inputs
        self.state = state
        dev = state.active.device
        # Masked warm-up: every budget 0, so no step runs unmasked.
        budgets = inputs["budgets"].clone()
        inputs["budgets"].zero_()
        body(inputs)
        inputs["budgets"].copy_(budgets)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.ptrs = [t.data_ptr() for t in state_tensors(state)
                     + _scratch(dev)]
        counters = launch_counters()
        before = [getattr(fn, a) for fn, a in counters]
        t0 = time.perf_counter()
        try:
            self._replay, self.outputs, self.pool_bytes = capture(
                lambda: body(inputs))
        finally:
            after = [getattr(fn, a) for fn, a in counters]
            for (fn, a), n in zip(counters, before):
                setattr(fn, a, n)
        self.capture_s = time.perf_counter() - t0
        self.deltas = [(fn, a, m - n) for (fn, a), n, m
                       in zip(counters, before, after) if m != n]
        self.replays = 0

    def current(self, state) -> bool:
        """True when ``state`` (and the split scratch) sit at the captured
        addresses."""
        dev = state.active.device
        now = state_tensors(state) + _scratch(dev)
        return [t.data_ptr() for t in now] == self.ptrs

    def replay(self, state, **values) -> tuple[torch.Tensor, torch.Tensor]:
        """Copy ``values`` (name -> tensor, any device) into the static
        inputs, replay, and return copies of (tokens, done).  Raises if
        ``state`` is not the captured one."""
        if not self.current(state):
            raise RuntimeError("megastep graph replay against state tensors "
                               "other than the captured ones")
        for name, v in values.items():
            self.inputs[name].copy_(v)
        self._replay()
        for fn, a, d in self.deltas:
            setattr(fn, a, getattr(fn, a) + d)
        self.replays += 1
        tokens, done = self.outputs
        return tokens.clone(), done.clone()


class GraphCache:
    """A runner's captured megastep graphs, by key, and the state they
    were captured on."""

    def __init__(self, capture=cuda_capture):
        self._capture = capture
        self._graphs: dict = {}
        #: the state the newest graph was captured on (None before any)
        self.state = None
        self.captures = 0
        self.capture_s: list[float] = []
        self.pool_bytes: list[int] = []

    def graph(self, key, state, make_inputs, body) -> MegastepGraph:
        """The graph for ``key`` over ``state``: the cached one when
        ``state`` (and the split scratch) sit at its captured addresses,
        else a new capture (``make_inputs()`` -> static inputs, ``body``
        as :class:`MegastepGraph` takes it) that replaces it.  A new
        ``state`` drops every graph captured on another."""
        g = self._graphs.get(key)
        if g is not None and g.current(state):
            return g
        self._graphs = {k: v for k, v in self._graphs.items()
                        if v.state is state and v.current(state)}
        g = MegastepGraph(body, state, make_inputs(), self._capture)
        self._graphs[key] = g
        self.state = state
        self.captures += 1
        self.capture_s.append(g.capture_s)
        self.pool_bytes.append(g.pool_bytes)
        return g
