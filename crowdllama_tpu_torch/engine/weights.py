"""Weights: random init from a seed, weights carried across from numpy,
native checkpoints and local HF checkpoints.

Counterpart of ``crowdllama_tpu/engine/weights.py``.  Nothing is
downloaded.  A native checkpoint is the engine's own layout on disk: a
``config.json`` holding the marker key and the whole ``ModelConfig``, and
a ``model.safetensors`` holding the flattened parameter dict (the JAX
package's ``/``-joined names, float32, as ``train/distill.py`` and
``save_params`` there write it).  An HF checkpoint is a directory of
``config.json`` and one or more ``*.safetensors`` shards under the
``transformers`` names (``model.safetensors.index.json`` maps names to
shards): :func:`config_from_hf_dir` derives its ``ModelConfig`` and
:func:`load_safetensors_params` feeds ``models/convert.py``.  The
safetensors format is read and written here with numpy alone (an 8-byte
little-endian header length, a JSON header of dtype, shape and byte
offsets, then the raw little-endian buffers); a file is read through a
copy-on-write memory map, one tensor at a time, so loading copies each
tensor once, into the stacked parameter.  ``BF16`` tensors are read as
``uint16`` and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import struct
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import torch

from crowdllama_tpu_torch.models import transformer as T
from crowdllama_tpu_torch.models.config import ModelConfig, RopeScaling
from crowdllama_tpu_torch.ops.quant import random_quantized_params

log = logging.getLogger("crowdllama.torch.engine.weights")

#: the config.json key that marks a native checkpoint
NATIVE_MARKER = "crowdllama_tpu_native"

# safetensors dtype names -> numpy dtypes (BF16 as its raw uint16 bits).
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items() if k != "BF16"}


def init_params(cfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str = "cpu",
                quantize: str = "") -> dict:
    """Random weights made on ``device`` from ``torch.Generator(seed)``;
    with ``quantize`` born quantized (``ops/quant.py
    random_quantized_params``: no full-precision tree)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if quantize:
        return random_quantized_params(cfg, gen, dtype=dtype, mode=quantize,
                                       device=device)
    return T.init_params(cfg, gen, dtype=dtype, device=device)


#: the expert banks' stacked leaves ([L, E, ...] in an MoE model)
EXPERT_KEYS = ("w_gate", "w_up", "w_down")
_ONES = ("ln1", "ln2", "post_ln1", "post_ln2", "q_norm", "k_norm",
         "final_norm")
_ZEROS = ("bq", "bk", "bv")


def _piece_generator(seed: int, device, *where) -> torch.Generator:
    """A generator of its own for one piece of the weights, seeded from
    ``seed`` and the piece's name and indices alone."""
    digest = hashlib.blake2b(repr((seed, *where)).encode(),
                             digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest, "little") >> 1)


def init_params_slice(cfg: ModelConfig, seed: int = 0, *,
                      layers=None, experts=None, layer_keys=None,
                      embed: bool = True,
                      dtype: torch.dtype = torch.bfloat16,
                      device: torch.device | str = "cpu") -> dict:
    """Random weights of one member's share of a sharded model, drawn
    piece by piece on ``device``: every non-layer leaf, every layer of a
    stacked leaf and every (layer, expert) of an expert leaf from a
    generator seeded by ``seed`` and that piece's name and global
    indices, so members given one seed hold the same values wherever
    their shares meet, and none draws more than its share.  ``layers``
    (global indices) and ``experts`` (expert ids of the expert leaves)
    select the share, None meaning all; ``layer_keys`` names the stacked
    leaves to hold (None: all); ``embed`` holds the embedding, the final
    norm and the lm_head.  Norm weights are ones, biases zeros, the other
    leaves normal over the square root of their fan-in, as
    ``T.init_params``; its values differ (one generator per piece)."""
    shapes = T.init_params(cfg, None, dtype=dtype, device="meta")
    layers = range(cfg.num_layers) if layers is None else list(layers)
    experts = (range(cfg.num_experts) if experts is None
               else list(experts))

    def draw(out: torch.Tensor, name: str, *where) -> None:
        if name in _ONES:
            out.fill_(1)
        elif name in _ZEROS:
            out.zero_()
        else:
            fan_in = out.shape[-1] if name == "embed" else out.shape[-2]
            gen = _piece_generator(seed, device, name, *where)
            w = torch.randn(tuple(out.shape), generator=gen, device=device,
                            dtype=torch.float32)
            out.copy_(w.div_(math.sqrt(fan_in)))

    stacked: dict = {}
    for name, meta in shapes["layers"].items():
        if layer_keys is not None and name not in layer_keys:
            continue
        piece = tuple(meta.shape[1:])
        if cfg.is_moe and name in EXPERT_KEYS:
            leaf = torch.empty((len(layers), len(experts), *piece[1:]),
                               dtype=dtype, device=device)
            for i, layer in enumerate(layers):
                for j, e in enumerate(experts):
                    draw(leaf[i, j], name, layer, e)
        else:
            leaf = torch.empty((len(layers), *piece), dtype=dtype,
                               device=device)
            for i, layer in enumerate(layers):
                draw(leaf[i], name, layer)
        stacked[name] = leaf
    params: dict = {"layers": stacked}
    if embed:
        for name, meta in shapes.items():
            if name != "layers":
                params[name] = torch.empty(tuple(meta.shape), dtype=dtype,
                                           device=device)
                draw(params[name], name)
    return params


def params_from_numpy(flat: dict[str, np.ndarray],
                      dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cpu") -> dict:
    """Rebuild the parameter dict from the JAX package's flat ``/``-joined
    names (``layers/wq``, ``embed``, ...: its ``_flatten_params``), casting
    to ``dtype`` on ``device``.  A quantized weight comes as the JAX
    ``QTensor``'s / ``QTensor4``'s fields, ``<name>/q`` (int8) and
    ``<name>/s`` (its scales, bf16 as ``ml_dtypes.bfloat16``), and becomes
    the port's class with both kept in their own dtypes (a ``QTensor4``
    when ``s`` has the rank of ``q``).  The full dict serves a one-device
    runner as it is; a tensor-parallel runner slices it per rank
    (``parallel/sharding.py shard_params``)."""
    from crowdllama_tpu_torch.ops.quant import QTensor, QTensor4

    params: dict = {}
    quantized = []
    for name, arr in flat.items():
        node = params
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        value = _host_tensor(arr)
        if leaf in ("q", "s") and parents:
            node[leaf] = value.to(device=device)
            quantized.append(parents)
        else:
            node[leaf] = value.to(device=device, dtype=dtype)
    for parents in quantized:
        *up, key = parents
        node = params
        for p in up:
            node = node[p]
        if isinstance(node[key], dict):
            q, s = node[key]["q"], node[key]["s"]
            node[key] = (QTensor4 if s.dim() == q.dim() else QTensor)(q=q, s=s)
    return params


def _host_tensor(arr) -> torch.Tensor:
    """A numpy array (``ml_dtypes.bfloat16`` as ``torch.bfloat16``) or a
    tensor, as a host tensor of its own dtype."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ---------------------------------------------------------------- safetensors

class SafetensorsFile:
    """One safetensors file, its header parsed and its body mapped
    (copy-on-write, so tensors are writable views that never touch the
    file); :meth:`get` returns one tensor without copying it."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.header: dict = header
        self._base = 8 + n
        size = self.path.stat().st_size
        self._map = (np.memmap(self.path, dtype=np.uint8, mode="c")
                     if size > self._base else np.zeros(0, np.uint8))

    def keys(self) -> list[str]:
        return list(self.header)

    def get(self, name: str) -> torch.Tensor:
        meta = self.header[name]
        kind = meta["dtype"]
        if kind not in _ST_DTYPES:
            raise ValueError(f"{self.path}: tensor {name} has dtype {kind}, "
                             f"which this reader does not know")
        start, end = meta["data_offsets"]
        dt = np.dtype(_ST_DTYPES[kind])
        raw = self._map[self._base + start:self._base + end]
        t = torch.from_numpy(raw.view(dt).reshape(meta["shape"]))
        return t.view(torch.bfloat16) if kind == "BF16" else t


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the host (BF16 as
    ``torch.bfloat16``), each a view of the file's memory map."""
    f = SafetensorsFile(path)
    return {name: f.get(name) for name in f.keys()}


def _st_array(value) -> tuple[str, np.ndarray]:
    """(safetensors dtype name, a little-endian numpy view) of a numpy
    array or a host tensor (``torch.bfloat16`` as its uint16 bits)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", t.view(torch.uint16).numpy()
        value = t.numpy()
    arr = np.ascontiguousarray(value)
    kind = _ST_NAMES.get(arr.dtype)
    if kind is None:
        raise ValueError(f"dtype {arr.dtype} has no safetensors name")
    return kind, arr.astype(arr.dtype.newbyteorder("<"), copy=False)


def write_safetensors(tensors: dict, path: str | Path) -> None:
    """Write numpy arrays or host tensors (``torch.bfloat16`` as ``BF16``)
    as a safetensors file (names sorted, buffers packed in that order, the
    header padded with spaces to 8 bytes), one tensor at a time."""
    header: dict = {}
    offset, arrays = 0, []
    for name in sorted(tensors):
        try:
            kind, arr = _st_array(tensors[name])
        except ValueError as e:
            raise ValueError(f"tensor {name}: {e}") from None
        header[name] = {"dtype": kind, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        arrays.append(arr)
        offset += arr.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for arr in arrays:
            f.write(memoryview(arr.reshape(-1)).cast("B"))


# ---------------------------------------------------------- native checkpoints

def is_native_checkpoint(path: str | Path) -> bool:
    cfg_file = Path(path).expanduser() / "config.json"
    if not cfg_file.exists():
        return False
    try:
        return bool(json.loads(cfg_file.read_text()).get(NATIVE_MARKER))
    except (OSError, ValueError):
        return False


def require_native_checkpoint(path: str | Path, what: str) -> None:
    """Raise unless ``path`` is a native checkpoint."""
    if not is_native_checkpoint(path):
        raise ValueError(
            f"{what}={str(path)!r} is not a native checkpoint (no "
            f"{NATIVE_MARKER} marker in its config.json)")


def is_hf_checkpoint(path: str | Path) -> bool:
    """A directory holding a ``config.json`` without the native marker
    and at least one ``*.safetensors`` file."""
    path = Path(path).expanduser()
    return (path.is_dir() and (path / "config.json").exists()
            and not is_native_checkpoint(path)
            and any(path.glob("*.safetensors")))


def require_checkpoint(path: str | Path, what: str) -> None:
    """Raise unless ``path`` is a native or an HF checkpoint directory."""
    if not (is_native_checkpoint(path) or is_hf_checkpoint(path)):
        raise ValueError(
            f"{what}={str(path)!r} is not a checkpoint directory: neither "
            f"a native checkpoint ({NATIVE_MARKER} marker in its "
            f"config.json) nor an HF checkpoint (config.json and "
            f"*.safetensors)")


def flatten_params(params: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """The parameter dict as ``/``-joined names -> float32 numpy arrays (the
    on-disk dtype of a native checkpoint: bf16 widens exactly)."""
    out: dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = v.detach().to("cpu", torch.float32).numpy()
    return out


def save_params(cfg: ModelConfig, params: dict, out_dir: str | Path,
                meta: dict | None = None) -> Path:
    """Write a native checkpoint: config.json (marker, the whole
    ModelConfig, ``meta``) and model.safetensors (float32).  The JAX
    package's ``load_native_params`` reads it, and this module's
    :func:`load_native_params` reads the JAX package's."""
    out = Path(out_dir).expanduser()
    out.mkdir(parents=True, exist_ok=True)
    doc = {NATIVE_MARKER: True, "model_config": asdict(cfg)}
    if meta:
        doc["meta"] = meta
    (out / "config.json").write_text(json.dumps(doc, indent=2))
    write_safetensors(flatten_params(params), out / "model.safetensors")
    return out


def native_config_from_dir(path: str | Path) -> ModelConfig:
    """The ModelConfig a native checkpoint was saved with."""
    require_native_checkpoint(path, "checkpoint")
    d = json.loads((Path(path).expanduser() / "config.json").read_text())
    mc = dict(d["model_config"])
    if mc.get("rope_scaling") is not None:
        mc["rope_scaling"] = RopeScaling(**mc["rope_scaling"])
    return ModelConfig(**mc)


def load_native_params(cfg: ModelConfig, path: str | Path,
                       dtype: torch.dtype = torch.bfloat16,
                       device: torch.device | str = "cpu") -> dict:
    """A native checkpoint as the parameter dict, cast to ``dtype`` on
    ``device``.  Every name and shape ``cfg`` implies must be in the file
    (the names a random init of ``cfg`` makes, on the meta device)."""
    require_native_checkpoint(path, "checkpoint")
    flat = read_safetensors(Path(path).expanduser() / "model.safetensors")
    ref = flatten_shapes(cfg)
    for key, shape in ref.items():
        if key not in flat:
            raise KeyError(f"native checkpoint {path} missing {key}")
        if tuple(flat[key].shape) != shape:
            raise ValueError(
                f"native checkpoint {path}: {key} has shape "
                f"{tuple(flat[key].shape)}, config wants {shape}")
    return params_from_numpy({k: flat[k] for k in ref}, dtype=dtype,
                             device=device)


def flatten_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """``/``-joined parameter names -> shapes for ``cfg`` (no storage)."""
    params = T.init_params(cfg, None, dtype=torch.float32, device="meta")

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, tuple(v.shape)

    return dict(walk(params))


# ------------------------------------------------------------ HF checkpoints

def load_or_init_params(cfg: ModelConfig, model_path: str = "",
                        dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                        device: torch.device | str = "cpu") -> dict:
    """A native checkpoint, else an HF checkpoint, else (no path, or a
    path without safetensors, with a warning) random weights from
    ``seed``; loaded weights land on the host in ``dtype``."""
    if model_path:
        path = Path(model_path).expanduser()
        if is_native_checkpoint(path):
            log.info("loading native checkpoint from %s", path)
            return load_native_params(cfg, path, dtype=dtype)
        if path.is_dir() and list(path.glob("*.safetensors")):
            log.info("loading weights from %s", path)
            return load_safetensors_params(cfg, path, dtype=dtype)
        log.warning("model_path %s has no safetensors; using random init",
                    path)
    return init_params(cfg, seed=seed, dtype=dtype, device=device)


def load_safetensors_params(cfg: ModelConfig, path: str | Path,
                            dtype: torch.dtype = torch.bfloat16) -> dict:
    """Lazy multi-shard reader feeding the HF-name converter: the shards
    ``model.safetensors.index.json`` maps names to, else every
    ``*.safetensors`` in the directory; each shard is mapped once, on its
    first tensor, and every tensor is read when the converter asks."""
    from crowdllama_tpu_torch.models.convert import params_from_hf

    path = Path(path).expanduser()
    files: dict[str, SafetensorsFile] = {}

    def shard(fname: str) -> SafetensorsFile:
        if fname not in files:
            files[fname] = SafetensorsFile(path / fname)
        return files[fname]

    index_file = path / "model.safetensors.index.json"
    if index_file.exists():
        weight_map: dict[str, str] = json.loads(
            index_file.read_text())["weight_map"]

        def get(name: str) -> torch.Tensor:
            return shard(weight_map[name]).get(name)
    else:
        names = {n: p.name for p in sorted(path.glob("*.safetensors"))
                 for n in shard(p.name).keys()}

        def get(name: str) -> torch.Tensor:
            if name not in names:
                raise KeyError(f"tensor {name} not found in {path}")
            return shard(names[name]).get(name)

    return params_from_hf(cfg, get, dtype=dtype)


def save_hf_checkpoint(state_dict: dict[str, torch.Tensor],
                       config: dict, out_dir: str | Path,
                       shards: int = 1) -> list[Path]:
    """Write an HF checkpoint: ``config`` as config.json and the state
    dict (host tensors, as they are) in ``shards`` safetensors files of
    about equal size; with more than one, a
    ``model.safetensors.index.json`` maps each name to its shard.
    Returns the shard paths."""
    out = Path(out_dir).expanduser()
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps(config, indent=2))
    if shards <= 1:
        path = out / "model.safetensors"
        write_safetensors(state_dict, path)
        return [path]
    names = list(state_dict)
    total = sum(t.numel() * t.element_size() for t in state_dict.values())
    groups: list[list[str]] = [[]]
    size = 0
    for name in names:
        t = state_dict[name]
        if (groups[-1] and len(groups) < shards
                and size >= total * len(groups) / shards):
            groups.append([])
        groups[-1].append(name)
        size += t.numel() * t.element_size()
    paths, weight_map = [], {}
    for k, group in enumerate(groups):
        fname = f"model-{k + 1:05d}-of-{len(groups):05d}.safetensors"
        write_safetensors({n: state_dict[n] for n in group}, out / fname)
        weight_map.update({n: fname for n in group})
        paths.append(out / fname)
    (out / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=2))
    return paths


def _rope_scaling_from_hf(d: dict | None) -> RopeScaling | None:
    """``rope_scaling`` of a config.json as a RopeScaling (None and
    "default" mean none); types other than llama3 and linear raise."""
    if not d:
        return None
    kind = d.get("rope_type") or d.get("type") or ""
    if kind in ("", "default"):
        return None
    if kind == "llama3":
        return RopeScaling(
            rope_type="llama3", factor=float(d["factor"]),
            low_freq_factor=float(d.get("low_freq_factor", 1.0)),
            high_freq_factor=float(d.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                d.get("original_max_position_embeddings", 8192)))
    if kind == "linear":
        return RopeScaling(rope_type="linear", factor=float(d["factor"]))
    raise ValueError(f"unsupported rope_scaling type {kind!r} "
                     f"(supported: llama3, linear)")


def resolve_clamped_model_config(config) -> ModelConfig:
    """The engine's model config for a node Configuration: the registry
    entry or the checkpoint's config.json, its context clamped to
    ``config.max_context_length``."""
    cfg = resolve_model_config(config.model, config.model_path)
    if config.max_context_length:
        cfg = replace(cfg, max_context_length=min(
            cfg.max_context_length, config.max_context_length))
    return cfg


def load_params_for(config, cfg: ModelConfig,
                    dtype: torch.dtype = torch.bfloat16,
                    device: torch.device | str = "cpu") -> dict:
    """Load-or-init for a node Configuration, then its weight-only
    quantization (``config.quantize``), as the engine does; quantized
    leaves stay where the weights were loaded, leaf by leaf."""
    params = load_or_init_params(cfg, config.model_path, dtype=dtype,
                                 device=device)
    if config.quantize:
        from crowdllama_tpu_torch.ops.quant import quantize_params

        params = quantize_params(params, mode=config.quantize)
    return params


def resolve_model_config(name: str, model_path: str = "",
                         **overrides) -> ModelConfig:
    """Registry lookup, with a checkpoint fallback: a name not in the
    registry serves from ``model_path``'s config.json under that name."""
    from crowdllama_tpu_torch.models.config import _REGISTRY, get_config

    if name in _REGISTRY or not model_path:
        return get_config(name, **overrides)
    path = Path(model_path).expanduser()
    if not (path / "config.json").exists():
        return get_config(name, **overrides)  # raises with the known list
    cfg = replace(config_from_hf_dir(path), name=name)
    return replace(cfg, **overrides) if overrides else cfg


def config_from_hf_dir(path: str | Path) -> ModelConfig:
    """A ModelConfig from a checkpoint's config.json: the family sniffed
    from ``architectures``, ``head_dim`` 0 unless given, the sliding
    window kept for gemma2 and mistral only."""
    d = json.loads((Path(path).expanduser() / "config.json").read_text())
    arch = (d.get("architectures") or [""])[0].lower()
    family = ("gemma2" if "gemma2" in arch
              else "mixtral" if "mixtral" in arch
              else "mistral" if "mistral" in arch
              else "qwen3" if "qwen3" in arch
              else "qwen2" if "qwen2" in arch else "llama")
    return ModelConfig(
        name=d.get("_name_or_path", "hf-model"),
        family=family,
        vocab_size=d["vocab_size"],
        hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=d["num_attention_heads"],
        num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
        head_dim=d.get("head_dim", 0),
        rope_theta=d.get("rope_theta", 10000.0),
        rope_scaling=_rope_scaling_from_hf(d.get("rope_scaling")),
        rms_norm_eps=d.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=d.get("tie_word_embeddings", False),
        max_context_length=d.get("max_position_embeddings", 4096),
        attn_logit_softcap=d.get("attn_logit_softcapping") or 0.0,
        final_logit_softcap=d.get("final_logit_softcapping") or 0.0,
        query_pre_attn_scalar=d.get("query_pre_attn_scalar") or 0.0,
        # The families whose serving paths window their layers
        # (transformer.layer_sliding_windows); others ignore the value.
        sliding_window=((d.get("sliding_window") or 0)
                        if family in ("gemma2", "mistral") else 0),
        post_norms=family == "gemma2",
        embedding_multiplier=((d["hidden_size"] ** 0.5)
                              if family == "gemma2" else 0.0),
        num_experts=d.get("num_local_experts", 0),
        num_experts_per_tok=d.get("num_experts_per_tok", 2),
        attn_qkv_bias=family == "qwen2" or bool(d.get("attention_bias")),
        qk_norm=family == "qwen3",
    )
