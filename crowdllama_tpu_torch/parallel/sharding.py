"""Partition rules over the (dp, pp, sp, ep, tp) mesh and the reductions
GSPMD derives.

Counterpart of ``crowdllama_tpu/parallel/sharding.py``: the same
:func:`param_pspecs` and :func:`cache_pspec`.  Megatron-style tensor
parallelism: attention QKV (and the Qwen biases) and MLP gate/up are
column-parallel (output dim on tp), attention output and MLP down
row-parallel (input dim on tp), the embedding and the LM head
vocab-sharded, norms replicated.  Layer-stacked leaves put their leading
layer axis on pp: a pipeline stage holds its contiguous ``L/pp`` layers
(``parallel/pipeline.py``).  MoE layers keep the router replicated and
shard the expert banks on ep along the expert axis, each expert still
split on F over tp (gate and up column-parallel, down row-parallel), so
each rank routes every token itself, runs its bank over the rows routed
to its experts, and its partial expert sums join the row-parallel sum.
Every other leaf is replicated over dp, sp and ep: each rank holds its own
copy.  Query heads shard in kv-major order, so tp rank r holds kv heads
``[r * Hkv/tp, (r + 1) * Hkv/tp)`` and exactly the query heads that read
them.  A quantized leaf (``ops/quant.py QTensor``) slices its values like
the weight and its per-channel scales like the weight without its input
axis; a ``QTensor4``'s group scales follow the weight's axes where they
divide and are otherwise replicated (a slice of the packed output axis
keeps nibble pairs whole).  The KV cache ``[L, B, Hkv, S, Dh]`` puts
layers on pp, slots on dp (block-sharded: slot ``b`` lives on dp rank
``b // (B/dp)``), kv heads on tp and the sequence on sp; int8 scales
follow the cache without Dh.

The JAX package leaves the collectives to GSPMD.  The port runs every
rank from one process, so it writes them out:

- :func:`row_parallel_sum`: the sum of the tp ranks' partial outputs after
  ``wo`` and after ``w_down``, in rank order;
- :func:`vocab_embed`: the sum of the vocab-sharded embedding lookups
  (exact: every other shard adds zeros);
- :func:`vocab_gather`: the gather of vocab-sharded logits;
- the ep combine: ``models/transformer.py _expert_ffn`` takes each
  bank's rows from its rank and the per-token sum keeps the one-device
  order, ascending by expert (``_moe_sorted``).

Each reduction returns its single input as it is when there is one shard,
so a one-device model (a list of one parameter dict) runs no extra
operation.  :func:`shard_params` makes the dict of every rank this
process holds; :func:`rank_groups` bundles them into the tp lists the
model's forward functions take, one for each (dp, pp, sp) coordinate,
with an expert leaf sharded on ep as :class:`ExpertBanks`.

On a mesh across processes (``parallel/multihost.py``) a tp group may
span processes: its list then holds this process's ranks only, as a
:class:`TPGroup` that carries the group's ``AxisComm``, and each
reduction combines the local parts as above, then sums over the group's
processes (one fp32 ``all_reduce``; the vocab-sharded embedding and
logits are written into zeros of the full width first, so their sums
stay exact).  With two processes of one rank each the sum is the one
addition the one-process loop makes, so the result is bit-identical;
with more ranks a process the local sums are added first.
"""

from __future__ import annotations

import weakref
from typing import Any

import torch

from crowdllama_tpu_torch.models.config import ModelConfig
from crowdllama_tpu_torch.ops.quant import (
    QTensor,
    QTensor4,
    drop_input_axis_spec,
)
from crowdllama_tpu_torch.parallel.mesh import (
    AXES,
    AXIS_DP,
    AXIS_EP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
)

Params = dict[str, Any]

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def param_pspecs(cfg: ModelConfig) -> Params:
    """Per-leaf partition tuples mirroring ``models.transformer.
    init_params``: JAX's ``PartitionSpec`` of each leaf as a tuple."""
    col = (AXIS_PP, None, AXIS_TP)   # [L, D, out] column-parallel
    row = (AXIS_PP, AXIS_TP, None)   # [L, in, D] row-parallel
    vec = (AXIS_PP, None)            # [L, D] norms
    layers: Params = {"ln1": vec, "ln2": vec,
                      "wq": col, "wk": col, "wv": col, "wo": row}
    if cfg.attn_qkv_bias:  # [L, out] follows the column-parallel dim
        layers.update(bq=(AXIS_PP, AXIS_TP), bk=(AXIS_PP, AXIS_TP),
                      bv=(AXIS_PP, AXIS_TP))
    if cfg.qk_norm:  # [L, Dh] per-head gains, replicated
        layers.update(q_norm=vec, k_norm=vec)
    if cfg.is_moe:  # [L, E, D, F] / [L, E, F, D]: experts on ep, F on tp
        layers.update(router=(AXIS_PP, None, None),
                      w_gate=(AXIS_PP, AXIS_EP, None, AXIS_TP),
                      w_up=(AXIS_PP, AXIS_EP, None, AXIS_TP),
                      w_down=(AXIS_PP, AXIS_EP, AXIS_TP, None))
    else:
        layers.update(w_gate=col, w_up=col, w_down=row)
    if cfg.post_norms:
        layers.update(post_ln1=vec, post_ln2=vec)
    specs: Params = {"embed": (AXIS_TP, None), "layers": layers,
                     "final_norm": ()}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, AXIS_TP)  # [D, V]
    return specs


def cache_pspec() -> tuple:
    """The KV cache ``[L, B, Hkv, S, Dh]``: layers on pp, slots on dp, kv
    heads on tp, sequence on sp (JAX's ``cache_pspec``); the int8 scales
    ``[L, B, Hkv, S]`` take the same without the last axis."""
    return (AXIS_PP, AXIS_DP, AXIS_TP, AXIS_SP, None)


def _slice_to(x, spec: tuple, coords: dict, sizes: dict,
              device: torch.device):
    """The slice of ``x`` at the mesh ``coords`` (axis -> index) under
    ``spec``, the axes of ``sizes`` (axis -> size), as a contiguous copy on
    ``device`` (replicated axes are copied whole); a quantized leaf is
    sliced by :func:`_slice_quantized`."""
    if isinstance(x, QTensor):
        return _slice_quantized(x, spec, coords, sizes, device)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, parts = x.shape[dim], sizes[axis]
        if n % parts:
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"{axis}={parts}")
        x = x.narrow(dim, coords[axis] * (n // parts), n // parts)
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    out.copy_(x)
    return out


def _slice_quantized(w: QTensor, spec: tuple, coords: dict, sizes: dict,
                     device: torch.device) -> QTensor:
    """A quantized leaf's slice: ``q`` under the weight's spec (the packed
    axis of int4 splits in whole bytes); int8 scales under the spec
    without the input axis; int4 group scales under the weight's spec
    where their axis divides, else whole (which keeps each rank's groups
    only when there is one group)."""
    q = _slice_to(w.q, spec, coords, sizes, device)
    nd = w.q.dim()
    if not isinstance(w, QTensor4):
        s_spec = drop_input_axis_spec(spec, nd)
    else:
        axes = tuple(spec) + (None,) * (nd - len(spec))
        s_spec = tuple(ax if ax is None or n % sizes[ax] == 0 else None
                       for n, ax in zip(w.s.shape, axes))
        if axes[-2] is not None and s_spec[-2] is None and w.s.shape[-2] > 1:
            raise ValueError(
                f"int4 scales of {w.s.shape[-2]} groups do not split over "
                f"{axes[-2]}={sizes[axes[-2]]} with the weight's input "
                f"axis")
    return type(w)(q=q, s=_slice_to(w.s, s_spec, coords, sizes, device))


def _tree_map(fn, tree: Params, specs: Params | None = None) -> Params:
    """``fn(leaf, spec)`` over a parameter tree (``spec`` None without
    ``specs``)."""
    return {k: (_tree_map(fn, v, None if specs is None else specs[k])
                if isinstance(v, dict)
                else fn(v, None if specs is None else specs[k]))
            for k, v in tree.items()}


def shard_params(params: Params, cfg: ModelConfig,
                 mesh: Mesh) -> list[Params]:
    """The parameter dict of every rank this process holds
    (``mesh.local_ranks``: every rank in one process), in rank order,
    each on its rank's device.  On one device the one dict holds ``params``' own tensors when
    they are already there (moved there otherwise).  On a mesh every leaf
    is a copy of the rank's slice (replicated leaves whole), so once the
    caller drops ``params`` (best kept on the host) the ranks together
    hold what JAX's sharded pytree does.  An axis that does not divide
    its dim raises (kv heads over tp checked by name: a head split inside
    a head's columns would divide)."""
    if mesh.size == 1:
        return [_tree_map(lambda x, _: x.to(mesh.devices[0]), params)]
    if cfg.num_kv_heads % mesh.tp:
        raise ValueError(f"{cfg.num_kv_heads} kv heads do not split over "
                         f"tp={mesh.tp}")
    specs = param_pspecs(cfg)
    out = []
    for r, d in zip(mesh.local_ranks, mesh.devices):
        coords = dict(zip(AXES, mesh.coords(r)))
        out.append(_tree_map(
            lambda x, spec, c=coords, d=d: _slice_to(x, spec, c, mesh.axes,
                                                     d),
            params, specs))
    return out


class ExpertBanks:
    """An expert leaf sharded on ep: each ep rank's bank (``[..., E/ep,
    ...]``, a tensor or a ``QTensor``) on its device, in rank order.
    Indexing takes the leading axes of every bank (a layer of a stacked
    leaf); ``device`` is the first bank's."""

    def __init__(self, banks):
        self.banks = tuple(banks)

    def __getitem__(self, idx) -> "ExpertBanks":
        return ExpertBanks(b[idx] for b in self.banks)

    def __len__(self) -> int:
        return len(self.banks)

    @property
    def device(self) -> torch.device:
        return self.banks[0].device


class TPGroup(list):
    """A tp list (per-rank dicts or values) that states whether it is
    whole.  With ``comm``, the ``parallel.multihost.AxisComm`` of a tp
    group that spans processes, it holds this process's ranks only and
    the reductions complete their sums over the other processes' ranks
    through it; without, it holds a whole model (a draft beside a split
    main model).  While a list with a comm lives in this process, a
    plain list that reaches a reduction is refused (:func:`tp_comm`), so
    a per-rank list rebuilt without :func:`like` fails loudly instead of
    returning a partial sum."""

    def __init__(self, items=(), comm=None):
        super().__init__(items)
        self.comm = comm
        if comm is not None:
            _SPLIT_LIVE[0] += 1
            weakref.finalize(self, _split_gone)


#: how many tp lists with a cross-process comm live in this process
_SPLIT_LIVE = [0]


def _split_gone() -> None:
    _SPLIT_LIVE[0] -= 1


def tp_comm(group) -> Any:
    """The cross-process comm of a tp list: a :class:`TPGroup`'s, None for
    a plain list; a plain list raises while a tp group of this process
    spans processes."""
    if isinstance(group, TPGroup):
        return group.comm
    if _SPLIT_LIVE[0]:
        raise RuntimeError(
            "a plain per-rank list reached a tp reduction while this "
            "process's tp groups span processes: its cross-process sum "
            "would be lost (rebuild per-rank lists with sharding.like, or "
            "state a whole model as TPGroup(items))")
    return None


def like(group, items: list) -> list:
    """``items`` as a tp list of the same kind as ``group`` (a
    :class:`TPGroup` keeps its comm; the copy is not counted live, as
    ``group`` outlives its use)."""
    if not isinstance(group, TPGroup):
        return items
    out = TPGroup(items)
    out.comm = group.comm
    return out


def rank_groups(shards: list[Params], mesh: Mesh, comm=None) -> dict:
    """The tp lists of parameter dicts the forward functions take, keyed
    by (dp, pp, sp) coordinates, for the groups this process holds ranks
    of (``shards`` are this process's ranks, as :func:`shard_params`
    returns them): the dicts of the tp ranks at ep 0, with each expert
    leaf replaced by the :class:`ExpertBanks` of the ep ranks at the same
    (dp, pp, sp, tp) when ep > 1.  Attention and the dense leaves run once
    over ep (JAX computes them on every ep rank, the same function), so
    the other ep ranks' copies of them are not kept.  A group whose tp
    ranks span processes is a :class:`TPGroup` over ``comm``."""
    first = mesh.local_ranks.start

    def local(r):
        return shards[r - first]

    groups = {}
    for d in range(mesh.dp):
        for p in range(mesh.pp):
            for s in range(mesh.sp):
                tps = []
                for t in range(mesh.tp):
                    r = mesh.rank(d, p, s, 0, t)
                    if not mesh.is_local(r):
                        continue
                    base = local(r)
                    if mesh.ep > 1 and "router" in base["layers"]:
                        layers = dict(base["layers"])
                        for k in EXPERT_LEAVES:
                            layers[k] = ExpertBanks(
                                local(e)["layers"][k] for e in
                                mesh.ranks_along(AXIS_EP, dp=d, pp=p, sp=s,
                                                 tp=t))
                        base = {**base, "layers": layers}
                    tps.append(base)
                if not tps:
                    continue
                groups[(d, p, s)] = (TPGroup(tps, comm)
                                     if len(tps) < mesh.tp else tps)
    return groups


def row_parallel_sum(parts: list[torch.Tensor], comm=None) -> torch.Tensor:
    """The psum after a row-parallel product: the shards' partial outputs
    added in rank order on rank 0's device, in fp32, rounded once to the
    parts' dtype; with ``comm`` (a tp group across processes) the local
    fp32 sum is then summed over the group's processes before the
    rounding."""
    if len(parts) == 1 and comm is None:
        return parts[0]
    dev = parts[0].device
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.to(dev).float()
    if comm is not None:
        comm.all_reduce(acc)
    return acc.to(parts[0].dtype)


def vocab_embed(tables: list[torch.Tensor], tokens: torch.Tensor,
                comm=None) -> torch.Tensor:
    """Embedding rows of ``tokens`` from vocab-sharded tables [V/tp, D]:
    each shard looks up the ids it holds and zeros elsewhere, and the
    lookups add up on rank 0's device (exact); with ``comm`` the local
    tables are the group's ranks from ``comm.offset`` on, and the sum
    runs over the group's processes too (in fp32, still exact)."""
    if len(tables) == 1 and comm is None:
        return tables[0][tokens]
    dev, out = tables[0].device, None
    lo = 0 if comm is None else comm.offset * tables[0].shape[0]
    for table in tables:
        n = table.shape[0]
        local = tokens.to(table.device) - lo
        hit = (local >= 0) & (local < n)
        rows = torch.where(hit[..., None], table[local.clamp(0, n - 1)],
                           torch.zeros((), dtype=table.dtype,
                                       device=table.device)).to(dev)
        out = rows if out is None else out + rows
        lo += n
    if comm is None:
        return out
    return comm.all_reduce(out.float()).to(out.dtype)


def vocab_gather(parts: list[torch.Tensor], comm=None) -> torch.Tensor:
    """Vocab-sharded logits [..., V/tp] gathered into [..., V] on rank 0's
    device; with ``comm`` this process's parts are written at their
    ranks' columns of a zeroed [..., V] and summed over the group's
    processes (exact: every other column adds zeros)."""
    if len(parts) == 1 and comm is None:
        return parts[0]
    dev = parts[0].device
    if comm is None:
        return torch.cat([p.to(dev) for p in parts], dim=-1)
    w = parts[0].shape[-1]
    full = torch.zeros((*parts[0].shape[:-1], w * comm.size),
                       dtype=torch.float32, device=dev)
    for i, p in enumerate(parts):
        lo = (comm.offset + i) * w
        full[..., lo:lo + w] = p.to(dev)
    return comm.all_reduce(full).to(parts[0].dtype)
