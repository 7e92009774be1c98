"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``.  Libraries land in ``crowdllama_tpu_torch/_build/``
named by a content hash of every source and the flags, so an edited source
rebuilds and an unchanged one loads the existing library.  :func:`build_all`
starts one ``nvcc`` per source at once and keeps each build's ``ptxas``
report (registers, stack and spills of every kernel instantiation) beside
its library, read by :func:`ptxas_usage`; every library's ``resources``
entry reports the dynamic shared memory an entry launches with and its
blocks per SM (:func:`kernel_resources`).  Nothing is built at import: the
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
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Where the CUDA toolkit is looked for when nvcc is not on PATH.
CUDA_ROOTS = ("/usr/local/cuda",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every kernel entry: library -> {symbol: argtypes}.  Every
# entry ends with the head dim (``dh``, 64 or 128: each kernel is compiled
# for both) and the stream.
SIGNATURES: dict[str, dict[str, list]] = {
    "flash_prefill": {
        # q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale, softcap,
        # window, dh, stream
        "flash_prefill": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                          _I, _P],
    },
    "flash_decode": {
        # q, k_cache, v_cache, seq_lens, scratch, counters, out, B, H, Hkv,
        # S, span, splits, scale, softcap, window, dh, stream
        "flash_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _F, _I, _I, _P],
    },
    "paged_attention": {
        # nranks, q[], pool_k[], pool_v[], out[] (host arrays of nranks
        # device pointers), table, seq_lens, scratch, counters, B, H, Hkv,
        # page, np, pps, splits, scale, softcap, window, dh, stream
        "paged_decode": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _F, _F, _I, _I, _P],
        # q, pool_k, pool_v, table, q_lens, kv_lens, out, B, C, H, Hkv, page,
        # np, chunk_slot, scale, softcap, window, dh, stream
        "ragged_paged": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _F, _F, _I, _I, _P],
        # the int8-pool variants: k_scale, v_scale follow pool_v
        # k_scale[], v_scale[] follow pool_v[]
        "paged_decode_i8": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P],
        "ragged_paged_i8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _F, _F, _I, _I, _P],
        # q, pool_k, pool_v, pages, ctx_len, kv_len, out, C, H, Hkv, page,
        # np, scale, softcap, window, dh, stream
        "ragged_chunk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                         _F, _I, _I, _P],
        "ragged_chunk_i8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _F, _F, _I, _I, _P],
    },
}

# Every library's build report: entry name, dh, query heads per kv head,
# int out[2] (dynamic shared memory bytes, blocks an SM holds).
RESOURCES = [ctypes.c_char_p, _I, _I, _P]

# Head dims every kernel is compiled for; the wrappers refuse others.
HEAD_DIMS = (64, 128)


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


def _log_path(name: str) -> Path:
    return _lib_path(name).with_suffix(".log")


def build_all() -> list[Path]:
    """Compile every library whose current build is missing, one ``nvcc``
    per source, all started together, each one's output kept in its
    ``.log``.  Returns the library paths."""
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
            _log_path(name).write_text(log)
            os.replace(tmp, out)  # atomic: concurrent builds agree
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return [_lib_path(name) for name in SIGNATURES]


# A kernel instantiation's mangled name: the kernel, then its template
# arguments (the pool type, bf16 or int8 = "a", and the head dim).
_KERNEL_RE = re.compile(r"\d([a-z_]+_kernel)I(?:13__nv_bfloat16|(a))?Li(\d+)E")


def ptxas_usage(name: str) -> list[dict]:
    """Registers, stack and spill bytes of every kernel instantiation in
    library ``name``'s current build, from its ``ptxas -v`` report (built
    first if needed)."""
    if not _log_path(name).exists():
        build_all()
    rows, cur = [], None
    for line in _log_path(name).read_text().splitlines():
        if "Compiling entry function" in line:
            m = _KERNEL_RE.search(line)
            cur = None if m is None else {
                "kernel": m.group(1),
                "dtype": "int8" if m.group(2) else "bf16",
                "dh": int(m.group(3))}
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
            rows.append(cur)
            cur = None
    return rows


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with argtypes
    and restype declared for every entry."""
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for sym, argtypes in {**SIGNATURES[name], "resources": RESOURCES}.items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def kernel_resources(name: str, symbol: str, dh: int, group: int,
                     device: torch.device) -> dict:
    """Entry ``symbol`` of library ``name`` at head dim ``dh`` and
    ``group`` query heads per kv head, on ``device``: the dynamic shared
    memory it launches with and how many of its blocks an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = library(name).resources(symbol.encode(), dh, group,
                                      ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{symbol} resources failed: cudaError {err}")
    return {"smem_bytes": out[0], "blocks_per_sm": out[1]}


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
