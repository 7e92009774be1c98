"""Weights: random init from a seed, weights carried across from numpy, and
native checkpoints.

Counterpart of ``crowdllama_tpu/engine/weights.py``.  Nothing is
downloaded.  A native checkpoint is the engine's own layout on disk: a
``config.json`` holding the marker key and the whole ``ModelConfig``, and
a ``model.safetensors`` holding the flattened parameter dict (the JAX
package's ``/``-joined names, float32, as ``train/distill.py`` and
``save_params`` there write it).  The safetensors format is read and
written here with numpy alone (an 8-byte little-endian header length, a
JSON header of dtype, shape and byte offsets, then the raw little-endian
buffers): ``BF16`` tensors are read as ``uint16`` and viewed as
``torch.bfloat16``.  HF-layout checkpoints (``config_from_hf_dir``,
``params_from_hf``) are not ported yet.
"""

from __future__ import annotations

import json
import struct
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

from crowdllama_tpu_torch.models import transformer as T
from crowdllama_tpu_torch.models.config import ModelConfig, RopeScaling

#: the config.json key that marks a native checkpoint
NATIVE_MARKER = "crowdllama_tpu_native"
_HF_ITEM = "ROADMAP Queue 1 item 9 (HF checkpoints)"

# safetensors dtype names -> numpy dtypes (BF16 as its raw uint16 bits).
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items() if k != "BF16"}


def init_params(cfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str = "cpu") -> dict:
    """Random weights made on ``device`` from ``torch.Generator(seed)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.init_params(cfg, gen, dtype=dtype, device=device)


def params_from_numpy(flat: dict[str, np.ndarray],
                      dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cpu") -> dict:
    """Rebuild the parameter dict from the JAX package's flat ``/``-joined
    names (``layers/wq``, ``embed``, ...: its ``_flatten_params``), casting
    to ``dtype`` on ``device``.  The full dict serves a one-device runner
    as it is; a tensor-parallel runner slices it per rank
    (``parallel/sharding.py shard_params``)."""
    params: dict = {}
    for name, arr in flat.items():
        node = params
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        value = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.array(arr))
        node[leaf] = value.to(device=device, dtype=dtype)
    return params


# ---------------------------------------------------------------- safetensors

def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the host (BF16 as
    ``torch.bfloat16``)."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out: dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        kind = meta["dtype"]
        if kind not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {kind}, which "
                             f"this reader does not know")
        start, end = meta["data_offsets"]
        dt = np.dtype(_ST_DTYPES[kind]).newbyteorder("<")
        arr = np.frombuffer(data, dtype=dt, count=(end - start) // dt.itemsize,
                            offset=base + start).reshape(meta["shape"])
        t = torch.from_numpy(arr.astype(dt.newbyteorder("="), copy=True))
        out[name] = t.view(torch.bfloat16) if kind == "BF16" else t
    return out


def write_safetensors(tensors: dict[str, np.ndarray],
                      path: str | Path) -> None:
    """Write numpy arrays as a safetensors file (names sorted, buffers
    packed in that order, the header padded with spaces to 8 bytes)."""
    header: dict = {}
    offset, bufs = 0, []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        kind = _ST_NAMES.get(arr.dtype)
        if kind is None:
            raise ValueError(f"tensor {name}: dtype {arr.dtype} has no "
                             f"safetensors name")
        buf = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": kind, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(buf)]}
        bufs.append(buf)
        offset += len(buf)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for buf in bufs:
            f.write(buf)


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
    """Raise unless ``path`` is a native checkpoint (HF-layout directories
    are not ported yet)."""
    if not is_native_checkpoint(path):
        raise ValueError(
            f"{what}={str(path)!r} is not a native checkpoint (no "
            f"{NATIVE_MARKER} marker in its config.json); HF-layout "
            f"checkpoints are not served by crowdllama_tpu_torch yet "
            f"({_HF_ITEM})")


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
