"""Pipeline parallelism over the ``pp`` mesh axis (GPipe schedule).

Counterpart of ``crowdllama_tpu/parallel/pipeline.py``.  The layer stack
is sharded on its leading axis (``parallel/sharding.py`` puts ``pp``
first in every stacked layer leaf and in the KV cache), so stage r holds
layers ``[r * L/pp, (r + 1) * L/pp)`` and its slice of the cache.  The
batch is cut into microbatches (:func:`pick_n_microbatches`); at step s
stage r takes microbatch ``s - r``, and stage r's output is stage r+1's
input at the next step (JAX's ``ppermute``).  Stages run the model's own
layer scans (``models/transformer.py scan_prefill_layers`` /
``scan_decode_layers``: kernel A / kernel D per tp rank) over their own
layers.  Within a process the schedule is a loop: JAX's body computes the bubble's out-of-range (stage, step) pairs
and discards them; the loop skips them, which computes the same function.
Each stage writes only its microbatch's slice of its own cache slice
(views of the stage's cache, updated in place).

``stages`` is the list of the stages' tp lists of parameter dicts (each
stage's ``rank_groups`` entry); the per-stage values (``ropes``, the
caches) are lists over the stages of per-tp-rank lists.  The embedding is
stage 0's, the final norm and the vocab projection the last stage's.

Across processes (``comm``, the pp group's ``AxisComm``: each process
holding a run of whole stages) ``stages`` and the per-stage values are
this process's stages'.  Every process walks the same schedule and runs
only its stages; JAX's ``ppermute`` becomes one ``all_gather`` over the
pp group at the end of each step at which a stage hands its output to
the next process's first stage (each member sending its last stage's
output, zeros when it idled), so the processes post the same collectives
in the same order.  The last stage's activations are then broadcast to
every process, which computes the logits from its own copy of the final
norm and the vocab projection (replicated over pp): the replicated slot
state samples the same tokens everywhere.
"""

from __future__ import annotations

from typing import Callable

import torch

from crowdllama_tpu_torch.models import transformer as T
from crowdllama_tpu_torch.models.config import ModelConfig
from crowdllama_tpu_torch.ops.attention import decode_attention, prefill_attention

Params = dict


def pick_n_microbatches(batch: int, pp: int) -> int:
    """Largest divisor of ``batch`` that is <= pp (pipeline utilization
    wants n_mb close to pp, correctness needs batch % n_mb == 0)."""
    for n in range(min(pp, batch), 0, -1):
        if batch % n == 0:
            return n
    return 1


def _stage_device(stage: list[Params]) -> torch.device:
    return stage[0]["final_norm"].device


def _schedule(n_mb: int, npp: int):
    """The GPipe schedule's live (step, stage, microbatch) triples, in
    order; the bubble's out-of-range pairs are left out."""
    for s in range(n_mb + npp - 1):
        for r in range(npp):
            if 0 <= s - r < n_mb:
                yield s, r, s - r


def _pipeline(npp: int, n_mb: int, mb: int, x: torch.Tensor,
              run, comm=None) -> list:
    """Drive the GPipe schedule: ``run(stage, microbatch, x_in)`` returns
    the stage's output, which is the next stage's input at the next step
    (stage 0 takes microbatch m of ``x``).  Returns the last stage's
    outputs by microbatch (None where another process holds it).

    With ``comm`` (the pp group across processes) this process runs only
    its stages ``[comm.offset, comm.offset + comm.local)``; at the end of
    every step at which a stage hands its output to a stage of the next
    process, every member makes one ``all_gather`` of its last stage's
    output (zeros when that stage idled), and each takes its first
    stage's input from the member before it.  Every process walks the
    same schedule, so each posts the same collectives in the same
    order."""
    first, n_local = (0, npp) if comm is None else (comm.offset,
                                                    comm.local)
    last = first + n_local - 1
    # The stages that take their input from another process: every
    # member's first stage but stage 0.
    entries = range(n_local, npp, n_local) if comm is not None else ()
    cur: list = [None] * npp
    nxt: list = cur
    outs: list = [None] * n_mb
    step = -1
    for s, r, m in _schedule(n_mb, npp):
        if s != step:  # the ppermute between two steps
            if step >= 0:
                cur = _hand_off(comm, step, n_mb, entries, nxt, first, last,
                                x[:mb])
            step, nxt = s, [None] * npp
        if not first <= r <= last:
            continue
        y = run(r, m, x[m * mb:(m + 1) * mb] if r == 0 else cur[r])
        if r == npp - 1:
            outs[m] = y
        else:
            nxt[r + 1] = y
    return outs


def _hand_off(comm, step: int, n_mb: int, entries, nxt: list, first: int,
              last: int, like: torch.Tensor) -> list:
    """The inputs of the step after ``step``: ``nxt``, this process's own
    hand-offs, and across processes its first stage's input from the
    member before it (one ``all_gather`` of every member's last stage's
    output, made when a stage before an entry ran at ``step``)."""
    if comm is None or not any(0 <= step - (e - 1) < n_mb for e in entries):
        return nxt
    send = nxt[last + 1] if last + 1 < len(nxt) else None
    parts = comm.all_gather(torch.zeros_like(like) if send is None
                            else send.to(like.device))
    if first > 0 and 0 <= step - (first - 1) < n_mb:
        nxt[first] = parts[comm.index - 1]
    return nxt


def _check(cfg: ModelConfig, b: int, npp: int, n_microbatches: int) -> int:
    n_mb = n_microbatches or pick_n_microbatches(b, npp)
    assert b % n_mb == 0, f"batch {b} must divide into {n_mb} microbatches"
    assert cfg.num_layers % npp == 0, (
        f"{cfg.num_layers} layers not divisible by pp={npp}")
    return n_mb


def _span(stages: list, comm) -> tuple[int, int]:
    """(pp, this process's first stage) of ``stages`` (this process's
    stages; every stage without ``comm``)."""
    if comm is None:
        return len(stages), 0
    return comm.size, comm.offset


def _joined(stages: list, outs: list, x: torch.Tensor, comm):
    """The last stage's outputs joined [B, ...] on the (local) last
    stage's device; across processes broadcast from the process that
    holds the last stage, so every process holds them."""
    dev = _stage_device(stages[-1])
    if comm is None or comm.index == len(comm.processes) - 1:
        out = torch.cat([o.to(dev) for o in outs])
    else:
        out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if comm is not None:
        comm.broadcast(out, len(comm.processes) - 1)
    return out


def pp_forward(stages: list[list[Params]], cfg: ModelConfig,
               tokens: torch.Tensor, positions: torch.Tensor,
               kv_valid: torch.Tensor | None = None,
               n_microbatches: int = 0, ropes: list | None = None,
               attention: Callable = prefill_attention, comm=None):
    """The shared pipeline body over a prompt batch tokens [B, T]: returns
    (the last stage's activations [B, T, D] before the final norm, ks, vs
    per stage per tp rank [L/pp, B, Hkv/tp, T, Dh]).  With ``comm`` (the
    pp group across processes) ``stages`` and ``ropes`` are this
    process's stages', ks/vs are theirs, and every process gets the
    activations."""
    npp, first = _span(stages, comm)
    b, t = tokens.shape
    n_mb = _check(cfg, b, npp, n_microbatches)
    mb = b // n_mb
    l_local = cfg.num_layers // npp
    windows = T.layer_sliding_windows(cfg)
    if kv_valid is None:
        kv_valid = torch.ones((b, t), dtype=torch.bool, device=tokens.device)
    x = T._embed(stages[0], cfg, tokens)
    ks = [[[] for _ in stage] for stage in stages]
    vs = [[[] for _ in stage] for stage in stages]

    def run(r, m, x_in):
        sl = slice(m * mb, (m + 1) * mb)
        i = r - first
        y, k, v = T.scan_prefill_layers(
            T.layer_stacks(stages[i]), windows[r * l_local:(r + 1) * l_local],
            cfg, x_in.to(_stage_device(stages[i])), positions[sl],
            kv_valid=kv_valid[sl], attention=attention,
            rope=None if ropes is None else ropes[i])
        for j in range(len(k)):
            ks[i][j].append(k[j])
            vs[i][j].append(v[j])
        return y

    out = _joined(stages, _pipeline(npp, n_mb, mb, x, run, comm), x, comm)
    return (out, [[torch.cat(k, dim=1) for k in st] for st in ks],
            [[torch.cat(v, dim=1) for v in st] for st in vs])


def pp_prefill(stages: list[list[Params]], cfg: ModelConfig,
               tokens: torch.Tensor, positions: torch.Tensor,
               kv_valid: torch.Tensor | None = None,
               n_microbatches: int = 0, ropes: list | None = None,
               attention: Callable = prefill_attention, comm=None):
    """Pipelined full-prompt forward: (logits [B, T, V] fp32, ks, vs per
    stage per tp rank [L/pp, B, Hkv/tp, T, Dh])."""
    out, ks, vs = pp_forward(stages, cfg, tokens, positions, kv_valid,
                             n_microbatches, ropes, attention, comm)
    return T._unembed(stages[-1], cfg, out), ks, vs


def pp_hidden_states(stages: list[list[Params]], cfg: ModelConfig,
                     tokens: torch.Tensor, positions: torch.Tensor,
                     kv_valid: torch.Tensor | None = None,
                     n_microbatches: int = 0, ropes: list | None = None,
                     attention: Callable = prefill_attention, comm=None
                     ) -> torch.Tensor:
    """Final-norm hidden states [B, T, D] through the microbatch pipeline:
    the embeddings forward on pp meshes (the stages' KV is dropped)."""
    out, _, _ = pp_forward(stages, cfg, tokens, positions, kv_valid,
                           n_microbatches, ropes, attention, comm)
    return T._norm(out, stages[-1][0]["final_norm"], cfg)


def pp_decode_step(stages: list[list[Params]], cfg: ModelConfig,
                   tokens: torch.Tensor, positions: torch.Tensor,
                   k_caches: list, v_caches: list, seq_lens: torch.Tensor,
                   ropes: list, n_microbatches: int = 0,
                   attention: Callable = decode_attention,
                   comm=None) -> torch.Tensor:
    """Pipelined decode of one token a slot: logits [B, V] fp32.
    ``k_caches``/``v_caches`` per stage per tp rank [L/pp, B, Hkv/tp, S,
    Dh], updated in place: each stage writes only its layers' slice, one
    microbatch's slots at a time.  With ``comm`` the stages, ropes and
    caches are this process's; every process gets the logits (each from
    its own copy of the vocab projection, replicated over pp)."""
    npp, first = _span(stages, comm)
    b = tokens.shape[0]
    n_mb = _check(cfg, b, npp, n_microbatches)
    mb = b // n_mb
    l_local = cfg.num_layers // npp
    windows = T.layer_sliding_windows(cfg)
    x = T._embed(stages[0], cfg, tokens)

    def run(r, m, x_in):
        sl = slice(m * mb, (m + 1) * mb)
        i = r - first
        return T.scan_decode_layers(
            T.layer_stacks(stages[i]),
            windows[r * l_local:(r + 1) * l_local], cfg,
            x_in.to(_stage_device(stages[i])), positions[sl],
            [kc[:, sl] for kc in k_caches[i]],
            [vc[:, sl] for vc in v_caches[i]], seq_lens[sl], ropes[i],
            attention=attention)

    out = _joined(stages, _pipeline(npp, n_mb, mb, x, run, comm), x, comm)
    return T._unembed(stages[-1], cfg, out)
