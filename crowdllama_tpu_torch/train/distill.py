"""Draft-model distillation for speculative decoding.

Counterpart of ``crowdllama_tpu/train/distill.py``: trains a small
(default 2-layer) draft transformer to mimic the main model's next-token
distribution, so ``spec_decode="draft"`` proposes tokens the verifier
accepts.  The corpus is sequences sampled from the teacher itself (a
random-length prefix, then the teacher's greedy or sampled continuation,
over an fp32 contiguous cache: kernel D's fp32 entry on the card), plus an
optional text file; the loss is a temperature-scaled KL to the teacher's
logits mixed with CE to the teacher's argmax (argmax agreement is the
acceptance objective); the optimizer is a hand-rolled Adam under a
warmup + cosine schedule.  Teacher and student run in fp32: their prefill
attention is kernel A's fp32 entry on the card, the student's through
``ops.cuda.flash.PrefillAttention`` (the kernel forward, the plain
function's gradient).  On the CPU every attention is the plain version.

What matches the JAX trainer: the corpus keys (the port's threefry:
``PRNGKey(seed)`` split into the text, random and init keys, then
``randint`` prefixes and lengths and ``categorical`` draws bit for bit),
the loss, the Adam step and the schedule (fp32, at float tolerance).
What is the port's own: random weights.  A teacher without
``teacher_path`` is ``engine/weights.py init_params(cfg, seed=0)`` in
fp32 on the trainer's device, the weights a checkpoint-less torch worker
on that device serves (before their bf16 cast), not JAX's ``PRNGKey(0)``
init; the student's init draws from a ``torch.Generator`` seeded with the
init key's 64 bits; the training batches' rows come from a
``torch.Generator`` seeded with ``seed``, where the JAX trainer draws them
with numpy.

Checkpoints are native (config.json + model.safetensors, the port's
``save_params``), so ``--spec-draft-path <out>`` serves the result on
either package.  CLI: ``crowdllama_tpu_torch.cli.main distill-draft``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from crowdllama_tpu_torch.engine import prng
from crowdllama_tpu_torch.models import transformer as T
from crowdllama_tpu_torch.models.config import ModelConfig
from crowdllama_tpu_torch.ops.attention import prefill_attention

log = logging.getLogger("crowdllama.torch.train.distill")


@dataclass
class DistillConfig:
    teacher: str = "tiny-test"   # registry name of the main model
    teacher_path: str = ""       # its checkpoint ("" = random init)
    draft_layers: int = 2
    steps: int = 1200
    batch: int = 16
    seq_len: int = 64
    corpus_seqs: int = 256       # teacher-rollout sequences to synthesize
    corpus_path: str = ""        # optional text file: its token windows
    #                              seed 3/4 of the rollout prefixes and its
    #                              raw chunks join the corpus
    max_prefix: int = 32         # longest rollout prefix
    sample_temperature: float = 0.0  # rollout sampling temp, 0 = greedy
    # Initialize embed/lm_head/final_norm from the teacher (cloned, then
    # fine-tuned).
    tie_embeddings: bool = True
    lr: float = 3e-3
    warmup_frac: float = 0.1
    kl_weight: float = 0.5       # loss = w*KL + (1-w)*CE(teacher argmax)
    kl_temperature: float = 2.0
    seed: int = 0
    out: str = ""                # checkpoint dir ("" = don't save)
    log_every: int = 50
    extra_meta: dict = field(default_factory=dict)
    device: str = "cuda"         # "cuda" (the card) or "cpu"


# ----------------------------------------------------------- param trees

def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _unflatten(like, leaves) -> dict:
    it = iter(leaves)
    return _tree_map(lambda _: next(it), like)


# --------------------------------------------------------------- corpus

@torch.inference_mode()
def rollout_corpus(cfg: ModelConfig, params, key, num_seqs: int,
                   seq_len: int, temperature: float,
                   prefix_pool: np.ndarray | None = None,
                   max_prefix: int = 32) -> np.ndarray:
    """Sample ``num_seqs`` sequences of ``seq_len`` tokens: a random-length
    prefix (drawn from ``prefix_pool``, a 1-D token array, when it is long
    enough, else uniform ids) followed by the teacher's own continuation,
    greedy at ``temperature`` 0, else sampled with the threefry key chain
    of ``key`` ([2] uint32).  One token per step over a contiguous fp32
    cache [L, B, Hkv, S, Dh] on the params' device."""
    dev = params["embed"].device
    b, s = num_seqs, seq_len
    max_prefix = max(2, min(max_prefix, seq_len))
    dh = cfg.resolved_head_dim()
    k_pref, k_len, k_samp = prng.split(np.asarray(key, np.uint32), 3)
    if prefix_pool is not None and len(prefix_pool) > max_prefix:
        starts = prng.randint(k_pref, (b,), 0, len(prefix_pool) - max_prefix)
        prefix = np.stack([np.asarray(prefix_pool[st:st + max_prefix])
                           for st in starts]).astype(np.int64)
    else:
        prefix = prng.randint(k_pref, (b, max_prefix), 0,
                              cfg.vocab_size).astype(np.int64)
    plens = prng.randint(k_len, (b,), min(4, max_prefix), max_prefix + 1)
    prefix_d = torch.from_numpy(prefix).to(dev)
    plens_d = torch.from_numpy(plens).to(dev)
    kc = torch.zeros((cfg.num_layers, b, cfg.num_kv_heads, s, dh),
                     dtype=torch.float32, device=dev)
    vc = torch.zeros_like(kc)
    rope = [T.rope_for(cfg, dev)]
    tok, key, toks = prefix_d[:, 0], k_samp, []
    for i in range(s):
        pos = torch.full((b,), i, dtype=torch.int32, device=dev)
        logits, kc, vc = T.decode_step([params], cfg, tok, pos, kc, vc,
                                       pos + 1, rope=rope)
        if temperature > 0:
            key, sub = prng.split(key)
            noise = torch.from_numpy(prng.gumbel(sub, tuple(logits.shape)))
            nxt = torch.argmax(logits.float() / temperature + noise.to(dev),
                               dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        # While inside the prefix, the "continuation" is the prefix itself.
        nxt = torch.where((i + 1) < plens_d,
                          prefix_d[:, min(i + 1, max_prefix - 1)], nxt)
        toks.append(tok)
        tok = nxt
    return torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)


def corpus_from_text(path: str, vocab_size: int, seq_len: int) -> np.ndarray:
    """Byte-level tokenization of a text file (bytes mod vocab), chunked
    into [N, S]."""
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8).astype(np.int32)
    data = data % vocab_size
    n = len(data) // seq_len
    if n == 0:
        raise ValueError(f"{path}: too short for even one {seq_len}-token "
                         "sequence")
    return data[: n * seq_len].reshape(n, seq_len)


# ----------------------------------------------------------------- loss

def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, t = tokens.shape
    return torch.arange(t, dtype=torch.int32,
                        device=tokens.device).expand(b, t).contiguous()


def distill_loss(draft_params, draft_cfg: ModelConfig, teacher_logits,
                 tokens, kl_weight: float, kl_temperature: float,
                 attention=prefill_attention):
    """KL(teacher||student, temperature tau, scaled tau^2) mixed with CE
    to the teacher's argmax; positions 0..T-2 predict tokens 1..T-1.
    Returns (loss, (kl, ce, agreement)), 0-d fp32 tensors.  ``attention``
    is the student's prefill attention (kernel A's dispatch by
    default)."""
    logits, _, _ = T.prefill([draft_params], draft_cfg, tokens,
                             _positions(tokens), attention=attention)
    s = logits[:, :-1].float()                  # student [B, T-1, V]
    th = teacher_logits[:, :-1].float()         # teacher [B, T-1, V]
    tau = kl_temperature
    p = torch.softmax(th / tau, dim=-1)
    logq = torch.log_softmax(s / tau, dim=-1)
    logp = torch.log_softmax(th / tau, dim=-1)
    kl = torch.sum(p * (logp - logq), dim=-1) * (tau * tau)  # [B, T-1]
    hard = torch.argmax(th, dim=-1)
    ce = -torch.log_softmax(s, dim=-1).gather(-1, hard[..., None])[..., 0]
    loss = kl_weight * kl.mean() + (1.0 - kl_weight) * ce.mean()
    agree = (torch.argmax(s, dim=-1) == hard).float().mean()
    return loss, (kl.mean(), ce.mean(), agree)


# ------------------------------------------------------------ optimizer

def _adam_init(params) -> dict:
    def zeros(tree):
        return _tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                         tree)

    return {"m": zeros(params), "v": zeros(params), "t": 0}


@torch.no_grad()
def _adam_update(grads, opt, params, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step.  The moments are the trainer's own and are updated
    in place (the same roundings as ``b1 * m + (1 - b1) * g``): a second
    copy of both would hold 10.5 GB beside a Gemma-2-9b-wide student's."""
    t = opt["t"] + 1

    def moment(acc, g, beta):
        return acc.mul_(beta).add_(g * (1 - beta))

    m = _tree_map(lambda m, g: moment(m, g.float(), b1), opt["m"], grads)
    v = _tree_map(lambda v, g: moment(v, torch.square(g.float()), b2),
                  opt["v"], grads)
    f = np.float32
    tf = f(t)
    scale = float(f(lr) * np.sqrt(f(1) - f(b2) ** tf) / (f(1) - f(b1) ** tf))
    params = _tree_map(
        lambda p, m, v: (p.float() - scale * m / (torch.sqrt(v) + eps)
                         ).to(p.dtype), params, m, v)
    return params, {"m": m, "v": v, "t": t}


def _lr_at(step: int, total: int, base: float, warmup_frac: float):
    """Warmup then cosine decay, in fp32: the learning rate at ``step``."""
    f = np.float32
    warm = np.maximum(f(1.0), f(warmup_frac * total))
    s = f(step)
    ramp = np.minimum(s / warm, f(1.0))
    prog = np.clip((s - warm) / np.maximum(f(1.0), f(total) - warm),
                   f(0.0), f(1.0))
    return f(base) * ramp * f(0.5) * (f(1.0) + np.cos(f(np.pi) * prog))


# ------------------------------------------------------------ the loop

def _train_step(draft_params, opt, draft_cfg, teacher_logits, tokens,
                steps: int, lr: float, warmup_frac: float,
                kl_weight: float, kl_temperature: float = 2.0,
                attention=prefill_attention):
    """One step: the loss's gradient by autograd, then Adam at the
    scheduled rate.  Returns (params, opt, loss, (kl, ce, agreement))."""
    params = _tree_map(lambda p: p.detach().requires_grad_(), draft_params)
    loss, aux = distill_loss(params, draft_cfg, teacher_logits, tokens,
                             kl_weight, kl_temperature, attention=attention)
    grads = _unflatten(params, torch.autograd.grad(loss, _leaves(params)))
    lr_t = _lr_at(opt["t"], steps, lr, warmup_frac)
    params, opt = _adam_update(grads, opt, params, lr_t)
    return params, opt, loss.detach(), tuple(a.detach() for a in aux)


@torch.no_grad()
def _teacher_logits(teacher_params, teacher_cfg: ModelConfig, tokens):
    logits, _, _ = T.prefill([teacher_params], teacher_cfg, tokens,
                             _positions(tokens))
    return logits.float()


def draft_config_for(teacher_cfg: ModelConfig, draft_layers: int,
                     max_context_length: int = 0) -> ModelConfig:
    """The draft's architecture: the teacher's shape cut to
    ``draft_layers`` layers (same vocab: verification compares ids)."""
    return replace(
        teacher_cfg,
        name=f"{teacher_cfg.name}-draft{draft_layers}l",
        num_layers=draft_layers,
        max_context_length=(max_context_length
                            or teacher_cfg.max_context_length))


def init_draft_params(draft_cfg: ModelConfig, key,
                      device: torch.device | str) -> dict:
    """The student's random fp32 init: a ``torch.Generator`` on ``device``
    seeded with the 64 bits of the init key ``key`` ([2] uint32)."""
    key = np.asarray(key, np.uint32)
    gen = torch.Generator(device=device).manual_seed(
        int(key[0]) << 32 | int(key[1]))
    return T.init_params(draft_cfg, gen, dtype=torch.float32, device=device)


def distill_keys(seed: int) -> np.ndarray:
    """The text-prefix, random-prefix and init keys of a run, [3, 2]
    (``PRNGKey(seed)``'s split into four, the first kept as the run's)."""
    return prng.split(prng.PRNGKey(seed), 4)[1:]


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; distillation runs on "
                           "the card (device='cpu' runs it on the CPU)")
    return dev


def distill_draft(dc: DistillConfig, teacher_cfg: ModelConfig | None = None,
                  teacher_params=None) -> dict:
    """Run the distillation on ``dc.device``; returns ``{"losses",
    "agreement", "draft_config", "draft_params", "checkpoint",
    "rollout_s", "rollout_tokens", "step_ms"}`` (``step_ms``: each train
    step's device time from CUDA events on the card, host time on the
    CPU).  ``teacher_cfg`` / ``teacher_params`` override the
    registry/checkpoint resolution (fp32 weights, moved to the device)."""
    from crowdllama_tpu_torch.engine.weights import (
        load_or_init_params,
        resolve_model_config,
        save_params,
    )

    dev = _device(dc.device)
    if teacher_cfg is None:
        teacher_cfg = resolve_model_config(dc.teacher, dc.teacher_path)
    if teacher_params is None:
        teacher_params = load_or_init_params(
            teacher_cfg, dc.teacher_path, dtype=torch.float32, device=dev)
    teacher_params = _tree_map(lambda x: x.to(dev, torch.float32),
                               teacher_params)
    draft_cfg = draft_config_for(teacher_cfg, dc.draft_layers)

    k_text, k_rand, k_init = distill_keys(dc.seed)
    t0 = time.perf_counter()
    parts, rolled = [], 0
    if dc.corpus_path:
        # Text-seeded rollouts dominate (3:1): prefixes from the prompt
        # distribution.
        with open(dc.corpus_path, "rb") as f:
            pool = (np.frombuffer(f.read(), np.uint8).astype(np.int32)
                    % teacher_cfg.vocab_size)
        n_text = (dc.corpus_seqs * 3) // 4
        parts.append(rollout_corpus(
            teacher_cfg, teacher_params, k_text, n_text, dc.seq_len,
            dc.sample_temperature, prefix_pool=pool,
            max_prefix=dc.max_prefix))
        parts.append(rollout_corpus(
            teacher_cfg, teacher_params, k_rand,
            dc.corpus_seqs - n_text, dc.seq_len, dc.sample_temperature,
            max_prefix=dc.max_prefix))
        rolled = sum(p.size for p in parts)
        parts.append(corpus_from_text(dc.corpus_path,
                                      teacher_cfg.vocab_size, dc.seq_len))
    else:
        parts.append(rollout_corpus(
            teacher_cfg, teacher_params, k_rand, dc.corpus_seqs,
            dc.seq_len, dc.sample_temperature, max_prefix=dc.max_prefix))
        rolled = parts[0].size
    corpus = np.concatenate(parts, axis=0)
    rollout_s = time.perf_counter() - t0
    log.info("corpus: %d sequences of %d tokens (%.1fs)",
             corpus.shape[0], corpus.shape[1], rollout_s)

    draft_params = init_draft_params(draft_cfg, k_init, dev)
    if dc.tie_embeddings:
        for k in ("embed", "lm_head", "final_norm"):
            if k in draft_params and k in teacher_params:
                # A clone: the student's Adam steps must never write the
                # teacher's tensors.
                draft_params[k] = teacher_params[k].detach().clone()
    opt = _adam_init(draft_params)
    rows_gen = torch.Generator().manual_seed(dc.seed)
    n = corpus.shape[0]

    losses: list[float] = []
    step_ms: list[float] = []
    agreement = 0.0
    t0 = time.perf_counter()
    for step in range(dc.steps):
        if n < dc.batch:
            rows = torch.randint(n, (dc.batch,), generator=rows_gen)
        else:
            rows = torch.randperm(n, generator=rows_gen)[:dc.batch]
        tokens = torch.from_numpy(corpus[rows.numpy()]).long().to(dev)
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        else:
            h0 = time.perf_counter()
        tl = _teacher_logits(teacher_params, teacher_cfg, tokens)
        draft_params, opt, loss, (kl, ce, agree) = _train_step(
            draft_params, opt, draft_cfg, tl, tokens, dc.steps, dc.lr,
            dc.warmup_frac, dc.kl_weight, dc.kl_temperature)
        if dev.type == "cuda":
            ev[1].record()
        losses.append(float(loss))
        agreement = float(agree)
        step_ms.append(ev[0].elapsed_time(ev[1]) if dev.type == "cuda"
                       else (time.perf_counter() - h0) * 1e3)
        if dc.log_every and (step % dc.log_every == 0
                             or step == dc.steps - 1):
            log.info("step %4d  loss %.4f  kl %.4f  ce %.4f  agree %.3f",
                     step, losses[-1], float(kl), float(ce), agreement)
    log.info("distilled %d steps in %.1fs (final loss %.4f, greedy "
             "agreement %.3f)", dc.steps, time.perf_counter() - t0,
             losses[-1], agreement)

    checkpoint = ""
    if dc.out:
        meta = {
            "teacher": teacher_cfg.name,
            "teacher_path": dc.teacher_path,
            "steps": dc.steps,
            "lr": dc.lr,
            "kl_weight": dc.kl_weight,
            "kl_temperature": dc.kl_temperature,
            "seq_len": dc.seq_len,
            "final_loss": losses[-1],
            "greedy_agreement": agreement,
            **dc.extra_meta,
        }
        checkpoint = str(save_params(draft_cfg, draft_params, dc.out,
                                     meta=meta))
        log.info("checkpoint: %s", checkpoint)
    return {
        "losses": losses,
        "agreement": agreement,
        "draft_config": draft_cfg,
        "draft_params": draft_params,
        "checkpoint": checkpoint,
        "rollout_s": rollout_s,
        "rollout_tokens": rolled,
        "step_ms": step_ms,
    }
