"""HF checkpoint tensors -> the port's parameter dict.

Counterpart of ``crowdllama_tpu/models/convert.py``: maps the
``transformers`` state-dict names of the families the port serves (Llama,
Mistral, Qwen2 with its q/k/v biases, Qwen3 with ``q_norm`` / ``k_norm``,
Gemma-2 with its four norms, Mixtral's ``block_sparse_moe`` router and
experts ``w1`` / ``w2`` / ``w3``) onto the stacked-layer dict of
``models/transformer.py``.  Projections are stored ``[out, in]`` by HF and
``[in, out]`` here, so each is transposed; every per-layer tensor is
stacked on a new leading axis (and an expert bank's experts on the next).
A tensor is converted to ``dtype`` on its own before the stack, so the
only full-size copy is the stacked result.  As in the JAX package, every
MoE config reads Mixtral's names (a Qwen3-MoE checkpoint's ``mlp.experts``
names are not read).  :func:`hf_state_dict` is the inverse: the HF names
of a parameter dict.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from crowdllama_tpu_torch.models.config import ModelConfig

TensorSource = Callable[[str], torch.Tensor]

# Mixtral's expert projections: (our name, HF's).
_EXPERTS = (("w_gate", "w1"), ("w_down", "w2"), ("w_up", "w3"))
_MOE = "model.layers.{i}.block_sparse_moe."


def params_from_hf(cfg: ModelConfig, get: TensorSource,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The parameter dict, pulling each tensor from ``get(name)`` (a lazy
    safetensors reader, or :func:`state_dict_source` over a state dict),
    on the host in ``dtype``."""
    nl = cfg.num_layers

    def one(name: str, transpose: bool) -> torch.Tensor:
        t = get(name)
        return (t.t() if transpose else t).to(dtype)

    def stack(fmt: str, transpose: bool = True) -> torch.Tensor:
        return torch.stack([one(fmt.format(i=i), transpose)
                            for i in range(nl)])

    attn = "model.layers.{i}.self_attn."
    layers: dict = {
        "wq": stack(attn + "q_proj.weight"),
        "wk": stack(attn + "k_proj.weight"),
        "wv": stack(attn + "v_proj.weight"),
        "wo": stack(attn + "o_proj.weight"),
        "ln1": stack("model.layers.{i}.input_layernorm.weight", False),
    }
    if cfg.attn_qkv_bias:  # Qwen2/2.5
        for p in "qkv":
            layers[f"b{p}"] = stack(attn + f"{p}_proj.bias", False)
    if cfg.qk_norm:  # Qwen3
        layers["q_norm"] = stack(attn + "q_norm.weight", False)
        layers["k_norm"] = stack(attn + "k_norm.weight", False)
    if cfg.family == "gemma2":
        layers["post_ln1"] = stack(
            "model.layers.{i}.post_attention_layernorm.weight", False)
        layers["ln2"] = stack(
            "model.layers.{i}.pre_feedforward_layernorm.weight", False)
        layers["post_ln2"] = stack(
            "model.layers.{i}.post_feedforward_layernorm.weight", False)
    else:
        layers["ln2"] = stack(
            "model.layers.{i}.post_attention_layernorm.weight", False)
    if cfg.is_moe:
        layers["router"] = stack(_MOE + "gate.weight")
        for ours, theirs in _EXPERTS:
            layers[ours] = torch.stack([
                torch.stack([one(_MOE.format(i=i) + f"experts.{x}.{theirs}"
                                 ".weight", True)
                             for x in range(cfg.num_experts)])
                for i in range(nl)])
    else:
        mlp = "model.layers.{i}.mlp."
        layers["w_gate"] = stack(mlp + "gate_proj.weight")
        layers["w_up"] = stack(mlp + "up_proj.weight")
        layers["w_down"] = stack(mlp + "down_proj.weight")

    params: dict = {
        "embed": one("model.embed_tokens.weight", False).contiguous(),
        "layers": layers,
        "final_norm": one("model.norm.weight", False).contiguous(),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = one("lm_head.weight", True).contiguous()
    return params


def state_dict_source(state_dict: Mapping[str, torch.Tensor]
                      ) -> TensorSource:
    """TensorSource over a state dict (detached, on the host)."""

    def get(name: str) -> torch.Tensor:
        return state_dict[name].detach().to("cpu")

    return get


def hf_state_dict(cfg: ModelConfig, params: dict) -> dict[str, torch.Tensor]:
    """The HF state dict of a parameter dict (projections transposed back
    to ``[out, in]``, the layer stack split), on the host; the inverse of
    :func:`params_from_hf`."""
    names = {"wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
             "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
             "bq": "self_attn.q_proj.bias", "bk": "self_attn.k_proj.bias",
             "bv": "self_attn.v_proj.bias",
             "q_norm": "self_attn.q_norm.weight",
             "k_norm": "self_attn.k_norm.weight",
             "ln1": "input_layernorm.weight",
             "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
             "w_down": "mlp.down_proj.weight"}
    if cfg.family == "gemma2":
        names.update(post_ln1="post_attention_layernorm.weight",
                     ln2="pre_feedforward_layernorm.weight",
                     post_ln2="post_feedforward_layernorm.weight")
    else:
        names["ln2"] = "post_attention_layernorm.weight"
    out: dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"].detach().cpu(),
        "model.norm.weight": params["final_norm"].detach().cpu()}
    experts = dict(_EXPERTS) if cfg.is_moe else {}
    names["router"] = "block_sparse_moe.gate.weight"
    for key, stacked in params["layers"].items():
        for i in range(cfg.num_layers):
            t = stacked[i].detach().cpu()
            if key in experts:
                for x in range(cfg.num_experts):
                    out[_MOE.format(i=i) + f"experts.{x}.{experts[key]}"
                        ".weight"] = t[x].t().contiguous()
                continue
            out[f"model.layers.{i}.{names[key]}"] = (
                t.t().contiguous() if t.dim() == 2 else t.clone())
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = params["lm_head"].detach().cpu().t() \
            .contiguous()
    return out
