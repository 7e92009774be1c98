"""Leader-replicated dispatch: the serving engine on a mesh across
processes (``parallel/multihost.py``'s driving model).

Counterpart of ``crowdllama_tpu/parallel/replicated.py``, with its op
numbers, frame layout and recovery rules.  Every process must issue the
same runner calls in the same order, or the first cross-process
collective waits forever.  The serving engine's scheduler makes load-
dependent decisions (admission order, chunk sizes, slot placement), so
they are made once, on process 0, and replicated as a stream of
fixed-shape command frames:

- the leader's engine wraps its runner in :class:`ReplicatedRunner`,
  which broadcasts one frame (op, scalar ints and floats, sampling key
  words; then the prompt, for ops that carry one) before it delegates
  each device-touching call to the real runner;
- every other process runs :func:`run_follower`: it builds the identical
  runner (``engine/factory.py``: same config, same params, checkpoint
  bytes or the seeded init) and replays frames until STOP.  Host
  bookkeeping (buckets, the paged allocator and prefix index, the spec
  runners' histories, the draft's cache) derives only from frame
  contents, so it stays the same everywhere.

Decode tokens come back through the collective readback: where dp spans
processes each process runs its own dp ranks' slots, and the tokens are
gathered in the global dp order (:func:`multihost.process_allgather`);
where every process runs every slot (tp across processes) the tokens are
already the same everywhere and no gather runs.  The readback is
synchronous, so multi-process serving gives up the double-buffered chunk
overlap, as in JAX.

As in JAX the proxy reports ``supports_adaptive_draft``,
``supports_ragged`` and ``supports_megastep`` False: the scheduler runs
legacy chunked admission and no megastep graphs.  The port's engine also
reaches runner calls JAX forwards unframed; those that would run on the
leader alone and leave the processes apart refuse here, loudly
(:data:`UNFRAMED`): KV page export and import (a donor fetch, a migrated
stream), the hosted verify of remote drafts (``supports_remote_draft``
False) and a leader-side ``set_draft_len``.  The read-only calls
(``chain_keys_for_prompt``, ``local_prefix_coverage``,
``prefill_prefers_monolithic``) pass through, as in JAX.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from crowdllama_tpu_torch.parallel import multihost

log = logging.getLogger("crowdllama.torch.parallel.replicated")

_OP_NOOP = 0
_OP_INIT = 1
_OP_PREFILL = 2
_OP_INSERT = 3
_OP_RELEASE = 4
_OP_DECODE = 5
_OP_PREFILL_BEGIN = 6
_OP_PREFILL_STEP = 7
_OP_PREFILL_FINISH = 8
_OP_STOP = 9
_OP_PREFILL_ABORT = 10
_OP_EMBED = 11
_OP_PRE_DECODE = 12
_OP_WARMUP_CTX = 13

_NI, _NF, _NK = 8, 4, 4  # frame scalar-int / float / key-word capacities

# Which header slot carries the prompt length for ops that stream one.
# EMBED streams a length-prefixed FLAT batch ([len0, t0.., len1, t1..]);
# slot 1 holds the flat array's total length (slot 0 = prompt count).
_PROMPT_LEN_SLOT = {_OP_PREFILL: 0, _OP_PREFILL_BEGIN: 0, _OP_INSERT: 4,
                    _OP_EMBED: 1}
# The port's runners take ``key=None`` for a greedy first token (JAX's
# always pass a key): PREFILL and PREFILL_FINISH mark it in this unused
# slot, so a frame with a key is JAX's frame word for word.
_NO_KEY_SLOT = _NI - 1
# PREFILL and PREFILL_BEGIN mark a leader call made without a state (the
# engine's warmup) in this unused slot, so the follower also runs it
# without one (no prefix lookup the leader skipped); a call with a state
# is JAX's frame word for word.
_NO_STATE_SLOT = _NI - 2

UNFRAMED = ("runner calls without a replay frame (KV page export and "
            "import, hosted verify of remote drafts, a leader-side "
            "set_draft_len) under multi-process serving (ROADMAP Queue 3 "
            "item 18)")


def _prompt_len_of(op: int, i32) -> int:
    slot = _PROMPT_LEN_SLOT.get(int(op))
    return 0 if slot is None else int(i32[slot])


def _key_words(key) -> np.ndarray:
    """A threefry key (``engine/prng.py``, [2] uint32) as the frame's
    ``_NK`` words."""
    out = np.zeros((_NK,), np.uint32)
    raw = np.asarray(key, np.uint32).ravel()
    out[: raw.size] = raw
    return out


def _key_from_words(words) -> np.ndarray:
    return np.asarray(words)[:2].astype(np.uint32)


def _zero_header() -> dict:
    return {"op": np.int32(0), "i32": np.zeros((_NI,), np.int32),
            "f32": np.zeros((_NF,), np.float32),
            "key": np.zeros((_NK,), np.uint32)}


class ReplicatedRunner:
    """Leader-side proxy: broadcast a frame, then run the real call.

    Implements the runner surface the scheduler and the engine's warmup
    use (init_state, prefill, prefill_begin/step/finish/abort, insert,
    release, decode_steps(_device), pre_decode_check,
    warmup_ctx_prefill, embed_prompt(s)), refuses the calls of
    :data:`UNFRAMED`, and passes every other attribute through to the
    inner runner."""

    defer_release = True  # releases broadcast; the scheduler defers them
    # Leader-local dials and paths without a replay frame: explicit class
    # attributes, so __getattr__ never leaks the inner runner's True.
    supports_adaptive_draft = False
    supports_ragged = False
    supports_megastep = False
    supports_remote_draft = False

    def __init__(self, inner):
        self.inner = inner
        if not hasattr(inner, "pre_decode_check"):
            self.pre_decode_check = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # ------------------------------------------------------------ frames

    def _bcast(self, op: int, ints=(), floats=(), key=None, prompt=()):
        """Two-phase frame: a fixed header always, the prompt as a second
        exact-length broadcast only for ops that carry one.  Both sides
        derive the second broadcast's shape from the header
        (:func:`_prompt_len_of`)."""
        i32 = np.zeros((_NI,), np.int32)
        i32[: len(ints)] = list(ints)
        f32 = np.zeros((_NF,), np.float32)
        f32[: len(floats)] = list(floats)
        kw = _key_words(key) if key is not None else np.zeros((_NK,),
                                                             np.uint32)
        multihost.broadcast_from_leader({
            "op": np.int32(op), "i32": i32, "f32": f32, "key": kw,
        })
        n = _prompt_len_of(op, i32)
        if n:
            assert len(prompt) == n, (op, len(prompt), n)
            multihost.broadcast_from_leader(np.asarray(list(prompt),
                                                       np.int32))

    def shutdown(self) -> None:
        """Release the follower loops (engine stop)."""
        self._bcast(_OP_STOP)

    def _refuse(self, name: str):
        raise NotImplementedError(
            f"{name} runs on the leader alone and would leave the processes "
            f"apart; not served: {UNFRAMED}")

    # ----------------------------------------------------- runner surface

    def init_state(self, seed: int = 0):
        self._bcast(_OP_INIT, ints=(int(seed),))
        return self.inner.init_state()

    def prefill(self, prompt_ids, temperature, top_p, key=None, state=None,
                top_k: int = 0, repeat_penalty: float = 1.0):
        ints = [len(prompt_ids), int(top_k)] + [0] * (_NI - 2)
        ints[_NO_KEY_SLOT] = 1 if key is None else 0
        ints[_NO_STATE_SLOT] = 1 if state is None else 0
        self._bcast(_OP_PREFILL, ints=ints,
                    floats=(float(temperature), float(top_p),
                            float(repeat_penalty)),
                    key=key, prompt=prompt_ids)
        return self.inner.prefill(prompt_ids, temperature, top_p, key,
                                  state=state, top_k=top_k,
                                  repeat_penalty=repeat_penalty)

    def prefill_begin(self, prompt_ids, state=None):
        ints = [len(prompt_ids)] + [0] * (_NI - 1)
        ints[_NO_STATE_SLOT] = 1 if state is None else 0
        self._bcast(_OP_PREFILL_BEGIN, ints=ints, prompt=prompt_ids)
        return self.inner.prefill_begin(prompt_ids, state=state)

    def prefill_step(self, job) -> bool:
        self._bcast(_OP_PREFILL_STEP)
        return self.inner.prefill_step(job)

    def prefill_finish(self, job, temperature, top_p, key=None,
                       top_k: int = 0, repeat_penalty: float = 1.0):
        ints = [int(top_k)] + [0] * (_NI - 1)
        ints[_NO_KEY_SLOT] = 1 if key is None else 0
        self._bcast(_OP_PREFILL_FINISH, ints=ints,
                    floats=(float(temperature), float(top_p),
                            float(repeat_penalty)), key=key)
        return self.inner.prefill_finish(job, temperature, top_p, key,
                                         top_k=top_k,
                                         repeat_penalty=repeat_penalty)

    def prefill_abort(self, job) -> None:
        """The leader abandoned a chunked prefill (the client cancelled
        mid-admission): followers drop the job, or they keep its KV
        accumulators until the next PREFILL_BEGIN replaces them."""
        self._bcast(_OP_PREFILL_ABORT)

    def insert(self, state, slot, ks, vs, plen, first, temperature, top_p,
               prompt_tokens=None, slot_key=None, top_k: int = 0,
               repeat_penalty: float = 1.0):
        prompt = list(prompt_tokens or [])
        self._bcast(_OP_INSERT, ints=(int(slot), int(plen), int(first),
                                      int(top_k), len(prompt),
                                      1 if slot_key is not None else 0),
                    floats=(float(temperature), float(top_p),
                            float(repeat_penalty)),
                    key=slot_key, prompt=prompt)
        return self.inner.insert(state, slot, ks, vs, plen, first,
                                 temperature, top_p,
                                 prompt_tokens=prompt_tokens,
                                 slot_key=slot_key, top_k=top_k,
                                 repeat_penalty=repeat_penalty)

    def release(self, state, slot):
        self._bcast(_OP_RELEASE, ints=(int(slot),))
        return self.inner.release(state, slot)

    def decode_steps_device(self, state, num_steps: int = 1):
        """Framed decode; returns (host tokens as a CPU tensor, state):
        the collective readback (:func:`gather_tokens`), which followers
        mirror."""
        self._bcast(_OP_DECODE, ints=(int(num_steps),))
        toks, state = self.inner.decode_steps_device(state, num_steps)
        return torch.from_numpy(gather_tokens(self.inner, toks)), state

    def decode_steps(self, state, num_steps: int = 1):
        tokens, state = self.decode_steps_device(state, num_steps)
        return tokens.numpy(), state

    def pre_decode_check(self, steps: int):
        """Paged page-table growth is dispatch-time host bookkeeping that
        allocates pool pages: followers replay it in stream order, or
        their free lists (and page ids) part from the leader's."""
        self._bcast(_OP_PRE_DECODE, ints=(int(steps),))
        return self.inner.pre_decode_check(steps)

    def warmup_ctx_prefill(self, state) -> None:
        """The engine's warmup runs the suffix-over-cached-context prefill:
        a device computation, so every process issues it."""
        self._bcast(_OP_WARMUP_CTX)
        return self.inner.warmup_ctx_prefill(state)

    def embed_prompts(self, prompts):
        """Batch embeddings: the whole batch rides one frame as a length-
        prefixed flat token stream, so the follower's call batches as the
        leader's."""
        if not prompts:
            return self.inner.embed_prompts(prompts)
        flat: list[int] = []
        for ids in prompts:
            flat.append(len(ids))
            flat.extend(int(t) for t in ids)
        self._bcast(_OP_EMBED, ints=(len(prompts), len(flat)), prompt=flat)
        return self.inner.embed_prompts(prompts)

    def embed_prompt(self, prompt_ids):
        return self.embed_prompts([prompt_ids])[0]

    # --------------------------------------------------- refused (UNFRAMED)

    def export_pages(self, *args, **kwargs):
        self._refuse("export_pages")

    def import_pages(self, *args, **kwargs):
        self._refuse("import_pages")

    def decode_steps_hosted(self, *args, **kwargs):
        self._refuse("decode_steps_hosted")

    def set_draft_len(self, k: int) -> None:
        self._refuse("set_draft_len")


def gather_tokens(runner, toks) -> np.ndarray:
    """The decode readback on every process: ``toks`` ([K, b] or the spec
    runners' [K, 2+J, b], the slots ``runner.slot_rows`` of this process)
    as the host array over every slot.  Where dp spans processes each
    process's rows are gathered (a collective every process makes) and
    placed at its slots; otherwise every process holds every slot."""
    host = multihost._host(toks)
    if not _rows_split(runner):
        return host
    parts = multihost.process_allgather(host, tiled=False)
    out = np.zeros((*host.shape[:-1], runner.max_slots), host.dtype)
    for p in range(parts.shape[0]):
        out[..., runner.process_slot_rows(p)] = parts[p]
    return out


def _rows_split(runner) -> bool:
    """Whether the slots are split over processes (dp across them)."""
    rows = runner.slot_rows
    return rows.stop - rows.start != runner.max_slots


def run_follower(config, devices=None, **build) -> int:
    """Follower main loop: build the identical runner, replay the
    leader's frame stream until STOP; returns the frames replayed.

    ``config`` must match the leader's engine fields (model, model_path,
    mesh, slots, context, quantize, kv layout and dtype, speculation):
    params are the same by construction (the same checkpoint bytes or the
    same seeded init).  ``devices`` are this process's devices (default:
    ``engine.factory.process_devices``); ``build`` passes the leader
    engine's ``dtype``, ``seed`` and ``model_config`` where they are not
    the defaults."""
    from crowdllama_tpu_torch.engine.factory import (
        build_process_runner,
        process_devices,
    )

    if devices is None:
        devices = process_devices(config)
    runner, plan, _cfg, _load_s = build_process_runner(
        config, devices=devices, **build)
    log.info("follower %d up: %s (%s) on %s", multihost.process_index(),
             runner.cfg.name, plan.runner, runner.devices)
    state = None
    pending = None  # the last prefill result awaiting insert
    job = None      # the current chunked-prefill job
    frames = 0
    # Set when an op failed here: a deterministic error is mirrored on the
    # leader, whose recovery broadcasts INIT as its very next frame, so a
    # poisoned follower accepts only INIT (and NOOP/STOP).  Any other op
    # means the failure was local to this process (a transient device
    # error, a local OOM): its shards have parted from the leader's, and
    # replaying frames against them would corrupt the tokens the leader
    # serves.  It fails loudly instead: terminating turns the leader's next
    # collective into an error rather than wrong output.
    poisoned = False
    while True:
        frame = multihost.broadcast_from_leader(_zero_header())
        op = int(frame["op"])
        i32 = np.asarray(frame["i32"])
        f32 = np.asarray(frame["f32"])
        n_prompt = _prompt_len_of(op, i32)
        if n_prompt:
            frame = dict(frame)
            frame["prompt"] = np.asarray(multihost.broadcast_from_leader(
                np.zeros((n_prompt,), np.int32)))
        frames += 1
        if op == _OP_STOP:
            log.info("follower %d: stop after %d frames",
                     multihost.process_index(), frames)
            return frames
        if op == _OP_NOOP:
            continue
        if poisoned and op != _OP_INIT:
            raise RuntimeError(
                f"follower {multihost.process_index()} state diverged from "
                f"the leader (a local op failure was not mirrored: the next "
                f"frame was op {op}, not INIT); terminating so the "
                f"divergence fails loudly instead of serving corrupted "
                f"tokens")
        try:
            state, pending, job = _apply(runner, state, pending, job, op,
                                         frame, i32, f32)
            poisoned = False
        except ValueError:
            # Request-level deterministic error: the leader catches exactly
            # ValueError at its admission sites, fails only that request,
            # and does not broadcast INIT; the same error here is mirrored,
            # state has not diverged, and the follower keeps replaying.
            log.warning("follower op %d: request-level error (mirrored on "
                        "the leader); continuing", op, exc_info=True)
            pending = None
            job = None
        except Exception:
            # Engine-level error: if it was deterministic, the leader's loop
            # recovery mirrors it and broadcasts INIT, which rebuilds state
            # here.  Mark poisoned; the next frame decides.
            log.exception("follower op %d failed; awaiting leader recovery",
                          op)
            poisoned = True
            pending = None
            job = None


def _apply(runner, state, pending, job, op, frame, i32, f32):
    """Execute one frame; returns the updated (state, pending, job)."""
    if op == _OP_INIT:
        state = runner.init_state()
    elif op == _OP_PREFILL:
        n, top_k = int(i32[0]), int(i32[1])
        prompt = [int(t) for t in np.asarray(frame.get("prompt", []))[:n]]
        key = None if i32[_NO_KEY_SLOT] else _key_from_words(frame["key"])
        pending = runner.prefill(
            prompt, float(f32[0]), float(f32[1]), key,
            state=None if i32[_NO_STATE_SLOT] else state,
            top_k=top_k, repeat_penalty=float(f32[2]))
    elif op == _OP_PREFILL_BEGIN:
        n = int(i32[0])
        prompt = [int(t) for t in np.asarray(frame["prompt"])[:n]]
        job = runner.prefill_begin(
            prompt, state=None if i32[_NO_STATE_SLOT] else state)
    elif op == _OP_PREFILL_STEP:
        runner.prefill_step(job)
    elif op == _OP_PREFILL_ABORT:
        job = None
    elif op == _OP_PREFILL_FINISH:
        key = None if i32[_NO_KEY_SLOT] else _key_from_words(frame["key"])
        pending = runner.prefill_finish(
            job, float(f32[0]), float(f32[1]), key, top_k=int(i32[0]),
            repeat_penalty=float(f32[2]))
        job = None
    elif op == _OP_INSERT:
        slot, plen, first = int(i32[0]), int(i32[1]), int(i32[2])
        n_prompt, has_key = int(i32[4]), int(i32[5])
        prompt = ([int(t) for t in np.asarray(frame["prompt"])[:n_prompt]]
                  if n_prompt else None)
        slot_key = _key_from_words(frame["key"]) if has_key else None
        _tok, ks, vs, _plen = pending
        state = runner.insert(state, slot, ks, vs, plen, first,
                              float(f32[0]), float(f32[1]),
                              prompt_tokens=prompt, slot_key=slot_key,
                              top_k=int(i32[3]),
                              repeat_penalty=float(f32[2]))
        pending = None
    elif op == _OP_RELEASE:
        state = runner.release(state, int(i32[0]))
    elif op == _OP_DECODE:
        toks, state = runner.decode_steps_device(state, int(i32[0]))
        if _rows_split(runner):  # mirror the leader's gather
            gather_tokens(runner, toks)
    elif op == _OP_PRE_DECODE:
        runner.pre_decode_check(int(i32[0]))
    elif op == _OP_WARMUP_CTX:
        runner.warmup_ctx_prefill(state)
    elif op == _OP_EMBED:
        n, total = int(i32[0]), int(i32[1])
        flat = ([int(t) for t in np.asarray(frame["prompt"])[:total]]
                if n else [])
        prompts, pos = [], 0
        for _ in range(n):
            ln = flat[pos]
            prompts.append(flat[pos + 1: pos + 1 + ln])
            pos += 1 + ln
        runner.embed_prompts(prompts)
    else:
        raise RuntimeError(f"unknown replicated op {op}")
    return state, pending, job
