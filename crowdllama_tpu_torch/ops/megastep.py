"""Kernel-looped decode megastep: K full decode steps per host dispatch.

Counterpart of ``crowdllama_tpu/ops/pallas/megastep.py``: the loop
harness around a runner's step body (which launches the attention
kernels), not a kernel of its own.  Each step samples on the device and
feeds its token straight back as the next step's input; the host reads a
``[K, B]`` token block and the per-slot done-flags once per flight.

The harness reads nothing back inside the loop, so the whole flight can
be captured in one CUDA graph (``engine/graphs.py``).  A graph cannot
branch, so all K bodies run.  JAX's ``while_loop`` exits once every live
slot has fired its done-flag; here a step past that exit runs masked:
before each step ``state.active`` is set to ``active0 & run`` in place
(``run`` = some slot still alive, or, on the ragged variant, the step
still carries prompt tokens), so the body writes its KV to the paged
pool's dump page (the contiguous cache: the slot's pending position,
past its valid length) and keeps every slot field.  The masked step's
token and done rows are zero, and ``seq_lens``, ``tokens``, ``recent``
and the KV of live pages end as JAX's exited loop leaves them.
``active0`` is restored after the loop.

The one difference from JAX: the runners split the slots' threefry keys
on the host at dispatch, K times, while JAX's exited loop leaves the keys
of its skipped steps unsplit.  It is invisible: every live slot has
fired by then, so the scheduler retires them all, and ``insert`` seeds a
slot's key anew.

Done-flags: ``done_now = (tok == eos) | (emitted >= budget)`` and
``fired = alive & done_now``, once per slot.  They only spare the host
per-step reads; the scheduler's ``_emit`` stays the authority on
retirement.
"""

from __future__ import annotations

import torch

# Budget sentinel for "no limit" (the scheduler always sends the real
# remaining budgets; runners default to it when called directly).
NO_BUDGET = 1 << 30


def _loop(step_fn, state, eos_ids, budgets, num_steps: int, pinned=None):
    """The masked K-step loop.  ``step_fn(i)`` runs step ``i`` on ``state``
    in place and returns its tokens [B] int32; ``pinned[i]`` (host bools)
    keeps step ``i`` running whatever the slots' flags.  Returns (tokens
    [K, B] int32, done [K, B] bool)."""
    active0 = state.active.clone()
    alive = active0 & (budgets > 0)
    emitted = torch.zeros_like(budgets)
    toks_rows, done_rows = [], []
    for i in range(num_steps):
        run = (torch.ones((), dtype=torch.bool, device=alive.device)
               if pinned is not None and pinned[i] else alive.any())
        state.active.copy_(active0 & run)
        before = state.tokens.clone()
        tok = step_fn(i)
        # A masked step's sampler zeroes the slots' pending tokens: put
        # them back, as an exited loop leaves them.
        state.tokens.copy_(torch.where(run, state.tokens, before))
        tok = torch.where(run, tok, torch.zeros_like(tok))
        emitted = emitted + 1
        done_now = (tok == eos_ids) | (emitted >= budgets)
        done_rows.append(alive & done_now)
        toks_rows.append(tok)
        alive = alive & ~done_now
    state.active.copy_(active0)
    return torch.stack(toks_rows), torch.stack(done_rows)


def run_decode_megastep(step_fn, state, eos_ids, budgets, num_steps: int):
    """Run ``num_steps`` decode steps of ``step_fn`` without a host read.

    ``step_fn(i)`` is the runner's per-step body on ``state`` (updated in
    place; step ``i`` picks its noise row) returning the step's tokens [B]
    int32.  ``eos_ids`` [B] int32 (-1 disables) and ``budgets`` [B] int32
    (tokens the host still wants from each slot) drive the done-flags;
    once no slot is alive the remaining steps run masked and their rows
    stay zero.  Returns ``(tokens [K, B], done [K, B] bool)``."""
    return _loop(step_fn, state, eos_ids, budgets, num_steps)


def run_ragged_megastep(step_fn, state, eos_ids, budgets, chunk_pending,
                        num_steps: int, vocab: int):
    """Run ``num_steps`` unified ragged steps (decode rows + one prefill
    chunk) with :func:`run_decode_megastep`'s flags, and JAX's two ragged
    extensions:

    - **The chunk pins the loop open.**  A step runs while some slot is
      alive or ``chunk_pending[i]`` (host bools: the step's context
      offset is short of the prompt's length), because the host commits
      the job's progress to the dispatch end before the flight runs.
    - **The last chunk row's logits ride out.**  ``step_fn(i)`` returns
      ``(tokens [B], chunk_logits [V] fp32 or None)``, None when the step
      carries no valid chunk row; the last non-None row is returned for
      ``ragged_finish`` (zeros when none).

    Returns ``(tokens [K, B], done [K, B] bool, last_logits [V])``."""
    last = [torch.zeros(vocab, dtype=torch.float32, device=budgets.device)]

    def step(i):
        tok, chunk_logits = step_fn(i)
        if chunk_logits is not None:
            last[0] = chunk_logits
        return tok

    tokens, done = _loop(step, state, eos_ids, budgets, num_steps,
                         pinned=chunk_pending)
    return tokens, done, last[0]
