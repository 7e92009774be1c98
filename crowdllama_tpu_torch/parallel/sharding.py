"""Tensor-parallel partition rules and the reductions GSPMD derives.

Counterpart of ``crowdllama_tpu/parallel/sharding.py`` for the ``tp``
axis: Megatron-style tensor parallelism with the JAX package's rules.
Attention QKV (and the Qwen biases) and MLP gate/up are column-parallel
(output dim on tp), attention output and MLP down row-parallel (input dim
on tp), the embedding and the LM head vocab-sharded, norms replicated.
Query heads shard in kv-major order, so rank r holds kv heads
``[r * Hkv/tp, (r + 1) * Hkv/tp)`` and exactly the query heads that read
them.

The JAX package leaves the collectives to GSPMD.  The port runs every
shard from one process, so it writes them out:

- :func:`row_parallel_sum`: the sum of the shards' partial outputs after
  ``wo`` and after ``w_down``, in rank order;
- :func:`vocab_embed`: the sum of the vocab-sharded embedding lookups
  (exact: every other shard adds zeros);
- :func:`vocab_gather`: the gather of vocab-sharded logits.

Each returns its single input as it is when there is one shard, so a tp=1
model (a list of one parameter dict) runs no extra operation.  MoE and pipeline (ep, pp) rules are not
ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from crowdllama_tpu_torch.models.config import ModelConfig
from crowdllama_tpu_torch.parallel.mesh import AXIS_TP, Mesh

Params = dict[str, Any]


def param_pspecs(cfg: ModelConfig) -> Params:
    """Per-leaf partition tuples mirroring ``models.transformer.
    init_params`` (layer leaves carry their leading layer axis); only the
    tp axis is named."""
    if cfg.is_moe:
        raise NotImplementedError("MoE partition rules are not ported yet "
                                  "(ROADMAP Queue 1 item 7)")
    col = (None, None, AXIS_TP)   # [L, D, out] column-parallel
    row = (None, AXIS_TP, None)   # [L, in, D] row-parallel
    layers: Params = {"ln1": (None, None), "ln2": (None, None),
                      "wq": col, "wk": col, "wv": col, "wo": row,
                      "w_gate": col, "w_up": col, "w_down": row}
    if cfg.attn_qkv_bias:  # [L, out] follows the column-parallel dim
        layers.update(bq=(None, AXIS_TP), bk=(None, AXIS_TP),
                      bv=(None, AXIS_TP))
    if cfg.qk_norm:  # [L, Dh] per-head gains, replicated
        layers.update(q_norm=(None, None), k_norm=(None, None))
    if cfg.post_norms:
        layers.update(post_ln1=(None, None), post_ln2=(None, None))
    specs: Params = {"embed": (AXIS_TP, None), "layers": layers,
                     "final_norm": (None,)}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, AXIS_TP)  # [D, V]
    return specs


def _slice_to(x: torch.Tensor, spec: tuple, rank: int, tp: int,
              device: torch.device) -> torch.Tensor:
    """Rank ``rank``'s slice of ``x`` under ``spec`` as a contiguous copy on
    ``device`` (replicated leaves are copied whole)."""
    if AXIS_TP in spec:
        dim = spec.index(AXIS_TP)
        n = x.shape[dim]
        if n % tp:
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"tp={tp}")
        x = x.narrow(dim, rank * (n // tp), n // tp)
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    out.copy_(x)
    return out


def _tree_map(fn, tree: Params, specs: Params | None = None) -> Params:
    """``fn(leaf, spec)`` over a parameter tree (``spec`` None without
    ``specs``)."""
    return {k: (_tree_map(fn, v, None if specs is None else specs[k])
                if isinstance(v, dict)
                else fn(v, None if specs is None else specs[k]))
            for k, v in tree.items()}


def shard_params(params: Params, cfg: ModelConfig,
                 mesh: Mesh) -> list[Params]:
    """The per-rank parameter dicts, each on its rank's device.  With tp=1
    the one dict holds ``params``' own tensors when they are already on
    the device (moved there otherwise).  With tp > 1 every leaf is a copy
    of the rank's slice, so once the caller drops ``params`` (best kept on
    the host) the ranks together hold one model's weights."""
    if mesh.size != mesh.tp:
        raise NotImplementedError(
            f"mesh {mesh.axes}: only the tp axis is ported (dp/pp/sp/ep "
            f"meshes: ROADMAP Queue 1 item 8)")
    if mesh.tp == 1:
        return [_tree_map(lambda x, _: x.to(mesh.devices[0]), params)]
    if cfg.num_kv_heads % mesh.tp:
        raise ValueError(f"{cfg.num_kv_heads} kv heads do not split over "
                         f"tp={mesh.tp}")
    specs = param_pspecs(cfg)
    return [_tree_map(lambda x, spec: _slice_to(x, spec, r, mesh.tp, d),
                      params, specs)
            for r, d in enumerate(mesh.devices)]


def row_parallel_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """The psum after a row-parallel product: the shards' partial outputs
    added in rank order on rank 0's device, in fp32, rounded once to the
    parts' dtype."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.to(dev).float()
    return acc.to(parts[0].dtype)


def vocab_embed(tables: list[torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tokens`` from vocab-sharded tables [V/tp, D]:
    each shard looks up the ids it holds and zeros elsewhere, and the
    lookups add up on rank 0's device (exact)."""
    if len(tables) == 1:
        return tables[0][tokens]
    dev, lo, out = tables[0].device, 0, None
    for table in tables:
        n = table.shape[0]
        local = tokens.to(table.device) - lo
        hit = (local >= 0) & (local < n)
        rows = torch.where(hit[..., None], table[local.clamp(0, n - 1)],
                           torch.zeros((), dtype=table.dtype,
                                       device=table.device)).to(dev)
        out = rows if out is None else out + rows
        lo += n
    return out


def vocab_gather(parts: list[torch.Tensor]) -> torch.Tensor:
    """Vocab-sharded logits [..., V/tp] gathered into [..., V] on rank 0's
    device."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=-1)
