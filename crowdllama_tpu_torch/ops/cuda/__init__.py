"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``.  Libraries land in ``crowdllama_tpu_torch/_build/``
named by a content hash of every source and the flags, so an edited source
rebuilds and an unchanged one loads the existing library.  :func:`build_all`
starts one ``nvcc`` per source at once.  Nothing is built at import: the
first wrapper launch (or an explicit :func:`build_all`) builds.

Each wrapper passes every pointer and the stream as ``c_void_p`` and each
scalar as ``c_int``/``c_float``; every C entry returns the
``cudaGetLastError()`` of its launch, which the wrapper raises on.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Where the CUDA toolkit is looked for when nvcc is not on PATH.
CUDA_ROOTS = ("/usr/local/cuda",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every kernel entry: library -> {symbol: argtypes}.
SIGNATURES: dict[str, dict[str, list]] = {
    "flash_prefill": {
        # q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale, softcap,
        # window, stream
        "flash_prefill": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                          _P],
    },
    "flash_decode": {
        # q, k_cache, v_cache, seq_lens, out, B, H, Hkv, S, scale, softcap,
        # window, stream
        "flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    },
    "paged_attention": {
        # q, pool_k, pool_v, table, seq_lens, out, B, H, Hkv, page, np,
        # scale, softcap, window, stream
        "paged_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                         _I, _P],
        # q, pool_k, pool_v, table, q_lens, kv_lens, out, B, C, H, Hkv, page,
        # np, chunk_slot, scale, softcap, window, stream
        "ragged_paged": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _F, _F, _I, _P],
        # the int8-pool variants: k_scale, v_scale follow pool_v
        "paged_decode_i8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _F, _F, _I, _P],
        "ragged_paged_i8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _F, _F, _I, _P],
        # q, pool_k, pool_v, pages, ctx_len, kv_len, out, C, H, Hkv, page,
        # np, scale, softcap, window, stream
        "ragged_chunk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                         _F, _I, _P],
        "ragged_chunk_i8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _F, _F, _I, _P],
    },
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), *CUDA_ROOTS):
        cand = Path(root) / "bin" / "nvcc"
        if root and cand.exists():
            return str(cand)
    raise KernelBuildError("nvcc not found (CUDA toolkit needed to build the "
                           "attention kernels)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def build_all() -> list[Path]:
    """Compile every library whose current build is missing, one ``nvcc``
    per source, all started together.  Returns the library paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SIGNATURES:
        out = _lib_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return [_lib_path(name) for name in SIGNATURES]


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with argtypes
    and restype declared for every entry."""
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for sym, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, symbol: str, device: torch.device, *args) -> None:
    """Call one C entry on the calling thread's current stream of
    ``device``; raise on a launch error.

    ``args`` are the entry's arguments without the trailing stream."""
    fn = getattr(library(name), symbol)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


def check(cond: bool, msg: str) -> None:
    """Argument validation for the wrappers (never stripped under -O)."""
    if not cond:
        raise ValueError(msg)
