"""Sequence parallelism: ring attention and the distributed decode.

Counterpart of ``crowdllama_tpu/ops/ring.py``, over the sp ranks'
sequence shards instead of a ``shard_map`` body.  Each function takes one
tensor a rank (each on its rank's device, in sp-rank order) and writes
out the collectives.  In one process every rank is there; when sp spans
processes (``parallel/multihost.py``) a process holds a run of the ranks
and the blocks it lacks come over the sp group (the ring's KV blocks,
gathered by the caller; the decode's partial sums, gathered here):

- :func:`ring_prefill_attention`: blockwise causal attention with the
  sequence sharded over sp.  JAX's ring rotates each KV shard (with its
  positions and ``kv_valid``) one hop per step and accumulates it into
  the resident query block with an online softmax (running max m,
  denominator l, output o in fp32); here a loop over (query shard, KV
  shard) pairs visits the KV shards in the ring's order (the query's own
  shard first, then its predecessors) through the same
  :func:`_block_accumulate`.  Positions and validity travel with their KV
  shard, so a padded tail is masked in every pair, not only the diagonal
  one.  Every pair is computed, as in the JAX body: a pair wholly above
  the causal diagonal adds nothing to (m, l, o) (its probabilities are
  masked to zero and the running max is unchanged), but telling which
  pairs those are would need the positions on the host.
- :func:`sp_cache_update`: one token a slot written into the sequence-
  sharded cache, each shard writing only where the position lands in it.
- :func:`sp_decode_attention`: flash-decoding across the shards.  Each
  shard computes its masked logits; JAX's ``pmax`` becomes the max of the
  shards' row maxima, and its two ``psum``s become sums of the shards'
  ``exp(logits - m)`` rows and their products with V, added in shard order
  in fp32.

JAX computes all three in jnp and reaches no Pallas kernel, so plain torch
is the port here on the card as well; these are not stand-ins for a
kernel.  Shapes follow the JAX functions': q ``[B, T, H, Dh]`` and k/v
``[B, T, Hkv, Dh]`` per shard for the ring; the decode cache head-major
``[B, Hkv, S/sp, Dh]`` per shard.
"""

from __future__ import annotations

import torch

from crowdllama_tpu_torch.ops.attention import NEG_INF, _softcap


def _block_accumulate(q, k, v, qpos, kpos, kv_valid, m, l, o, scale: float,
                      softcap: float, window: int):
    """One online-softmax accumulation of a KV block into (m, l, o).

    q [B, Tq, Hkv, G, Dh] fp32; k/v [B, Tc, Hkv, Dh] fp32; qpos [B, Tq];
    kpos [B, Tc]; kv_valid [B, Tc] bool; m/l [B, Hkv, G, Tq];
    o [B, Tq, Hkv, G, Dh]."""
    logits = _softcap(torch.einsum("bqhgd,bkhd->bhgqk", q, k) * scale,
                      softcap)
    qp = qpos[:, None, None, :, None]
    kp = kpos[:, None, None, None, :]
    mask = kp <= qp
    if window > 0:
        mask = mask & (kp > qp - window)
    mask = mask & kv_valid[:, None, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    new_m = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - new_m)
    p = torch.exp(logits - new_m[..., None])
    # A fully masked row has logits == new_m == NEG_INF: exp(0) = 1 there
    # would poison the accumulators.
    p = torch.where(mask, p, torch.zeros_like(p))
    new_l = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    new_o = o * alpha.permute(0, 3, 1, 2)[..., None] + pv
    return new_m, new_l, new_o


def ring_prefill_attention(qs: list[torch.Tensor], ks: list[torch.Tensor],
                           vs: list[torch.Tensor],
                           positions: list[torch.Tensor], scale: float, *,
                           softcap: float = 0.0, sliding_window: int = 0,
                           kv_valid: list[torch.Tensor] | None = None,
                           comm=None) -> list[torch.Tensor]:
    """Causal attention with the sequence sharded over the sp ranks.

    Per rank: q [B, T/sp, H, Dh], k/v [B, T/sp, Hkv, Dh] (a tp rank's
    heads), ``positions`` [B, T/sp] absolute, ``kv_valid`` [B, T/sp]
    bool (default all valid).  ``ks``, ``vs``, ``positions`` and
    ``kv_valid`` hold every sp rank's; with ``comm`` (the sp group across
    processes) ``qs`` holds this process's run of them only, from rank
    ``comm.offset``: each query shard visits the KV shards in the same
    ring order either way.  Returns each query shard's output [B, T/sp, H,
    Dh] in q's dtype on its device."""
    n = len(ks)
    first = 0 if comm is None else comm.offset
    if kv_valid is None:
        kv_valid = [torch.ones(p.shape, dtype=torch.bool, device=p.device)
                    for p in positions]
    window = int(sliding_window)
    outs = []
    for i, q in enumerate(qs, start=first):
        dev = q.device
        b, tq, h, dh = q.shape
        hkv = ks[i].shape[2]
        g = h // hkv
        qf = q.float().reshape(b, tq, hkv, g, dh)
        m = torch.full((b, hkv, g, tq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, tq), dtype=torch.float32, device=dev)
        o = torch.zeros((b, tq, hkv, g, dh), dtype=torch.float32, device=dev)
        qpos = positions[i].to(dev)
        for step in range(n):
            j = (i - step) % n  # the block the ring brings at this step
            m, l, o = _block_accumulate(
                qf, ks[j].to(dev).float(), vs[j].to(dev).float(), qpos,
                positions[j].to(dev), kv_valid[j].to(dev), m, l, o, scale,
                softcap, window)
        l = torch.clamp(l, min=1e-20)
        out = o / l.permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(b, tq, h, dh).to(q.dtype))
    return outs


def sp_cache_update(k_new: torch.Tensor, v_new: torch.Tensor,
                    positions: torch.Tensor, k_shards: list[torch.Tensor],
                    v_shards: list[torch.Tensor], comm=None) -> None:
    """Write one token's K/V a slot (k_new/v_new [B, Hkv, Dh], at
    ``positions`` [B]) into the sequence-sharded cache in place (shards
    [B, Hkv, S/sp, Dh], shard s holding positions ``[s * S/sp, (s + 1) *
    S/sp)``): each shard writes only the slots whose position it owns and
    rewrites the others' entries with their own values, as JAX's
    shard-local body does (no host read, so it runs in a CUDA graph).
    With ``comm`` (the sp group across processes) the shards given are
    this process's run of them, from shard ``comm.offset``: a position
    another process owns is written there only."""
    first = 0 if comm is None else comm.offset
    for s, (kc, vc) in enumerate(zip(k_shards, v_shards), start=first):
        dev, n = kc.device, kc.shape[2]
        local = positions.to(dev).long() - s * n
        sel = ((local >= 0) & (local < n))[:, None, None]
        idx = torch.clamp(local, 0, n - 1)
        bidx = torch.arange(kc.shape[0], device=dev)
        kc[bidx, :, idx] = torch.where(sel, k_new.to(dev, kc.dtype),
                                       kc[bidx, :, idx])
        vc[bidx, :, idx] = torch.where(sel, v_new.to(dev, vc.dtype),
                                       vc[bidx, :, idx])


def sp_gather(parts: list[torch.Tensor], comm) -> list[torch.Tensor]:
    """One tensor a local sp rank -> one a rank of the sp group, in shard
    order: ``parts`` as they are without ``comm``; across processes each
    member's run gathered (one ``all_gather``), on the first part's
    device."""
    if comm is None:
        return parts
    dev = parts[0].device
    mine = torch.stack([p.to(dev) for p in parts])
    return [x for member in comm.all_gather(mine) for x in member]


def sp_decode_attention(q: torch.Tensor, k_shards: list[torch.Tensor],
                        v_shards: list[torch.Tensor], seq_lens: torch.Tensor,
                        scale: float, *, softcap: float = 0.0,
                        sliding_window: int = 0,
                        comm=None) -> torch.Tensor:
    """Flash-decoding over the sequence-sharded cache: q [B, H, Dh],
    shards [B, Hkv, S/sp, Dh], ``seq_lens`` [B] (the new token included).
    Returns [B, H, Dh] in q's dtype on q's device.

    With ``comm`` (the sp group across processes) the shards are this
    process's run of them, from shard ``comm.offset``: each shard's row
    maxima are gathered (one ``all_gather``) for the pmax, then each
    shard's ``exp``-sums and their products with V (a second), and the
    psums add them in shard order on every process, which is the
    one-process merge bit for bit.  No ``all_reduce``: its order of
    summation is the backend's."""
    b, h, dh = q.shape
    hkv = k_shards[0].shape[1]
    g = h // hkv
    window = int(sliding_window)
    first = 0 if comm is None else comm.offset
    logits = []
    for s, kc in enumerate(k_shards, start=first):
        dev, n = kc.device, kc.shape[2]
        qg = q.to(dev).float().reshape(b, hkv, g, dh)
        lg = _softcap(torch.einsum("bhgd,bhkd->bhgk", qg, kc.float())
                      * scale, softcap)
        kpos = s * n + torch.arange(n, device=dev)[None, :]
        lens = seq_lens.to(dev)[:, None]
        valid = kpos < lens
        if window > 0:
            valid = valid & (kpos > (lens - 1) - window)
        logits.append(torch.where(valid[:, None, None, :], lg,
                                  torch.full_like(lg, NEG_INF)))
    m = None  # the pmax: the shards' row maxima, on q's device
    for mx in sp_gather([lg.amax(dim=-1).to(q.device) for lg in logits],
                        comm):
        m = mx if m is None else torch.maximum(m, mx)
    sums = []  # each shard's P.V and exp-sum, side by side [.., Dh + 1]
    for lg, vc in zip(logits, v_shards):
        p = torch.exp(lg - m.to(lg.device)[..., None])
        ls = p.sum(dim=-1).to(q.device)
        os_ = torch.einsum("bhgk,bhkd->bhgd", p, vc.float()).to(q.device)
        sums.append(torch.cat([os_, ls[..., None]], dim=-1))
    l = o = None  # the psums, in shard order
    for part in sp_gather(sums, comm):
        os_, ls = part[..., :dh], part[..., dh]
        l = ls if l is None else l + ls
        o = os_ if o is None else o + os_
    out = o / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)
