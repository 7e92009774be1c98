"""The native (C++) data plane, loaded through ctypes.

Counterpart of ``crowdllama_tpu/native/__init__.py`` over the port's own
copy of the source (``_src/crowdllama_native.cpp``): the frame scanner,
the Kademlia routing table, the per-session ChaCha20-Poly1305 AEAD and
the llama.v1 envelope fast paths.  It is host code; no device kernel is
involved.

The library is compiled with ``g++`` into ``crowdllama_tpu_torch/_build/``
under a name keyed by a hash of the source and the flags; each process
compiles into a temporary file of its own and renames it into place, so
concurrent first builds (pytest-xdist workers) cannot clobber each other.
Nothing is built at import.

A first build takes seconds, so ``load()`` never compiles on a thread
running an asyncio event loop: it starts the build on a daemon thread and
returns None (the Python path) until the library is ready.  Call
``ensure_built()`` from synchronous startup code (the CLI, chip_smoke.py)
to build first.  The Python path serves only where the library could not
load, and every such dispatch is counted per component
(``record_fallback``, ``stats``, exposed on ``/metrics``).  Set
``CROWDLLAMA_NO_NATIVE=1`` to force the Python path.
"""

from __future__ import annotations

import asyncio
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

log = logging.getLogger("crowdllama.torch.native")

_SRC = Path(__file__).parent / "_src" / "crowdllama_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_attempted = False
_bg_build: threading.Thread | None = None
_build_error = ""

TAG_LEN = 16
_FALSY = {"", "0", "false", "no", "off"}


def disabled() -> bool:
    """True when ``CROWDLLAMA_NO_NATIVE`` forces the Python path (unset,
    "", "0", "false", "no" and "off" leave it on)."""
    return os.environ.get("CROWDLLAMA_NO_NATIVE",
                          "").strip().lower() not in _FALSY


# ---------------------------------------------------------------------------
# Fallback accounting (exported on /metrics by the gateway and obs.http).

_fallback_lock = threading.Lock()
_fallbacks: dict[str, int] = {}


def record_fallback(component: str) -> None:
    """Count one Python-path dispatch of a native-capable component."""
    with _fallback_lock:
        _fallbacks[component] = _fallbacks.get(component, 0) + 1


_calls: dict[str, int] = {}


def record_call(component: str) -> None:
    """Count one native dispatch of a per-call component (``envelope``,
    ``frame_scan``): what shows that served frames took the library."""
    with _fallback_lock:
        _calls[component] = _calls.get(component, 0) + 1


def native_enabled() -> bool:
    """True when the native library is loaded and dispatching."""
    return _lib is not None and not disabled()


def stats() -> dict:
    """Snapshot for /metrics: the enabled flag, per-component fallback
    counts, per-component native calls (not exported) and the last build
    error ("" when none)."""
    with _fallback_lock:
        return {"enabled": native_enabled(), "fallbacks": dict(_fallbacks),
                "calls": dict(_calls), "build_error": _build_error}


# ---------------------------------------------------------------------------
# ctypes mirrors of the C structs (see _src/crowdllama_native.cpp).


class ClGenRespFields(ctypes.Structure):
    _fields_ = [
        ("model", ctypes.c_char_p), ("model_len", ctypes.c_size_t),
        ("response", ctypes.c_char_p), ("response_len", ctypes.c_size_t),
        ("done_reason", ctypes.c_char_p), ("done_reason_len", ctypes.c_size_t),
        ("worker_id", ctypes.c_char_p), ("worker_id_len", ctypes.c_size_t),
        ("trace_id", ctypes.c_char_p), ("trace_id_len", ctypes.c_size_t),
        ("parent_span", ctypes.c_char_p), ("parent_span_len", ctypes.c_size_t),
        ("created_seconds", ctypes.c_int64),
        ("total_duration", ctypes.c_int64),
        ("created_nanos", ctypes.c_int32),
        ("has_created", ctypes.c_int32),
        ("done", ctypes.c_int32),
        ("prompt_tokens", ctypes.c_int32),
        ("completion_tokens", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
    ]


class ClGenReqFields(ctypes.Structure):
    _fields_ = [
        ("model", ctypes.c_char_p), ("model_len", ctypes.c_size_t),
        ("prompt", ctypes.c_char_p), ("prompt_len", ctypes.c_size_t),
        ("kv_donor", ctypes.c_char_p), ("kv_donor_len", ctypes.c_size_t),
        ("trace_id", ctypes.c_char_p), ("trace_id_len", ctypes.c_size_t),
        ("parent_span", ctypes.c_char_p), ("parent_span_len", ctypes.c_size_t),
        ("msg_roles", ctypes.POINTER(ctypes.c_char_p)),
        ("msg_role_lens", ctypes.POINTER(ctypes.c_size_t)),
        ("msg_contents", ctypes.POINTER(ctypes.c_char_p)),
        ("msg_content_lens", ctypes.POINTER(ctypes.c_size_t)),
        ("stops", ctypes.POINTER(ctypes.c_char_p)),
        ("stop_lens", ctypes.POINTER(ctypes.c_size_t)),
        ("n_msgs", ctypes.c_int32),
        ("n_stop", ctypes.c_int32),
        ("stream", ctypes.c_int32),
        ("max_tokens", ctypes.c_int32),
        ("temperature", ctypes.c_float),
        ("top_p", ctypes.c_float),
        ("repeat_penalty", ctypes.c_float),
        ("top_k", ctypes.c_int32),
        ("seed", ctypes.c_uint64),
        ("migrate", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
    ]


class ClGenRespView(ctypes.Structure):
    _fields_ = [
        ("model_off", ctypes.c_uint32), ("model_len", ctypes.c_uint32),
        ("response_off", ctypes.c_uint32), ("response_len", ctypes.c_uint32),
        ("done_reason_off", ctypes.c_uint32),
        ("done_reason_len", ctypes.c_uint32),
        ("worker_id_off", ctypes.c_uint32), ("worker_id_len", ctypes.c_uint32),
        ("trace_id_off", ctypes.c_uint32), ("trace_id_len", ctypes.c_uint32),
        ("parent_span_off", ctypes.c_uint32),
        ("parent_span_len", ctypes.c_uint32),
        ("created_seconds", ctypes.c_int64),
        ("total_duration", ctypes.c_int64),
        ("created_nanos", ctypes.c_int32),
        ("has_created", ctypes.c_int32),
        ("done", ctypes.c_int32),
        ("prompt_tokens", ctypes.c_int32),
        ("completion_tokens", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
    ]


# The library is built on the machine that runs it, so tuning for the
# local CPU is safe; the flags are part of the cache key.
_CXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-std=c++17",
              "-shared", "-fPIC"]


def _compile(src: Path, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    try:
        try:
            subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(src)],
                           check=True, capture_output=True, timeout=120)
        except subprocess.CalledProcessError:
            # Some toolchains refuse -march=native; the portable flag set
            # builds the same semantics.
            subprocess.run(
                ["g++", *[f for f in _CXX_FLAGS if f != "-march=native"],
                 "-o", str(tmp), str(src)],
                check=True, capture_output=True, timeout=120)
        tmp.replace(out)
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    sz, vp, cp = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_char_p
    sigs = {
        "cl_frame_scan": (ctypes.c_long, [
            cp, sz, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32), sz, ctypes.POINTER(sz)]),
        "cl_rt_new": (vp, [cp, ctypes.c_int]),
        "cl_rt_free": (None, [vp]),
        "cl_rt_upsert": (ctypes.c_int, [vp, cp, u8p,
                                        ctypes.POINTER(ctypes.c_int)]),
        "cl_rt_remove": (ctypes.c_int, [vp, cp]),
        "cl_rt_size": (ctypes.c_long, [vp]),
        "cl_rt_closest": (ctypes.c_long, [vp, cp, ctypes.c_int, u8p]),
        "cl_rt_dump": (ctypes.c_long, [vp, u8p, ctypes.c_long]),
        "cl_aead_new": (vp, [cp]),
        "cl_aead_free": (None, [vp]),
        "cl_aead_ctr": (ctypes.c_uint64, [vp]),
        "cl_aead_seal_frames": (ctypes.c_long, [vp, cp, sz, sz, ctypes.c_int,
                                                cp, sz]),
        "cl_aead_open": (ctypes.c_long, [vp, cp, sz, cp, sz]),
        "cl_aead_seal_raw": (ctypes.c_long, [cp, cp, cp, sz, cp, sz, cp, sz]),
        "cl_env_encode_genresp": (ctypes.c_long, [
            ctypes.POINTER(ClGenRespFields), cp, sz]),
        "cl_env_encode_genreq": (ctypes.c_long, [
            ctypes.POINTER(ClGenReqFields), cp, sz]),
        "cl_env_decode_genresp": (ctypes.c_long, [
            cp, sz, ctypes.POINTER(ClGenRespView)]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def so_path() -> Path:
    """Where the library for this source and these flags lives."""
    src_hash = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"crowdllama_native-{src_hash}.so"


def _build_and_load() -> None:
    """Compile (if needed), dlopen and declare; sets _lib.  The caller
    holds _lock."""
    global _lib
    so = so_path()
    if not so.exists():
        _compile(_SRC, so)
    try:
        lib = _declare(ctypes.CDLL(str(so)))
    except OSError:
        # A corrupt cached artifact must not poison the cache: rebuild once.
        so.unlink(missing_ok=True)
        _compile(_SRC, so)
        lib = _declare(ctypes.CDLL(str(so)))
    _lib = lib
    log.debug("native library loaded: %s", so.name)


def _attempt() -> None:
    """One build-and-load attempt under _lock, remembering its error."""
    global _load_attempted, _build_error
    try:
        _build_and_load()
    except Exception as e:  # no g++, compile error, load error
        _build_error = f"{e.__class__.__name__}: {e}"
        log.info("native library unavailable (%s); using Python paths",
                 _build_error)
    _load_attempted = True


def _in_running_loop() -> bool:
    try:
        asyncio.get_running_loop()
        return True
    except RuntimeError:
        return False


def load() -> ctypes.CDLL | None:
    """The loaded library, building it first if needed; None when it
    cannot load (or while a background build runs)."""
    global _bg_build
    if disabled():
        return None
    if _lib is not None:
        return _lib
    # A background build holds _lock for the whole compile: a hot-path
    # caller must not queue on it.
    bg = _bg_build
    if bg is not None and bg.is_alive():
        return None
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        try:
            so_ready = so_path().exists()
        except OSError:
            so_ready = False
        if not so_ready and _in_running_loop():
            def _bg() -> None:
                with _lock:
                    if _lib is None and not _load_attempted:
                        _attempt()

            _bg_build = threading.Thread(
                target=_bg, name="crowdllama-native-build", daemon=True)
            _bg_build.start()
            return None
        _attempt()
        return _lib


def ensure_built() -> bool:
    """Blocking build and load for synchronous startup paths; True when
    the library is ready."""
    if disabled():
        return False
    if _lib is not None:
        return True
    with _lock:
        if _lib is None and not _load_attempted:
            _attempt()
    return _lib is not None


def _reset_for_tests() -> None:
    """Drop the cached load state and the fallback counts."""
    global _lib, _load_attempted, _bg_build, _build_error
    with _lock:
        _lib = None
        _load_attempted = False
        _bg_build = None
        _build_error = ""
    with _fallback_lock:
        _fallbacks.clear()


# ---------------------------------------------------------------------------
# AEAD session wrapper.


class AeadSession:
    """One direction of a secure stream: a native ChaCha20-Poly1305
    context with its own 96-bit big-endian nonce counter and reusable
    scratch buffers.  Construct only with a loaded library."""

    __slots__ = ("_lib", "_h", "_out", "_pt")

    def __init__(self, lib: ctypes.CDLL, key: bytes) -> None:
        if len(key) != 32:
            raise ValueError("AEAD key must be 32 bytes")
        self._lib = lib
        self._h = lib.cl_aead_new(key)
        self._out = ctypes.create_string_buffer(64 * 1024)
        self._pt = ctypes.create_string_buffer(64 * 1024)

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        h = getattr(self, "_h", None)
        if h:
            try:
                self._lib.cl_aead_free(h)
            except Exception:
                pass
            self._h = None

    @property
    def counter(self) -> int:
        return int(self._lib.cl_aead_ctr(self._h))

    def seal_frames(self, data: bytes, chunk: int,
                    with_eof: bool = False) -> bytes:
        """Chunk and seal ``data`` into concatenated wire frames
        ([4B BE len][ct||tag]...), advancing the counter once a frame:
        the bytes of the Python ``SecureWriter``."""
        n = len(data)
        nframes = (n + chunk - 1) // chunk + (1 if with_eof else 0)
        need = n + nframes * (4 + TAG_LEN)
        if need > len(self._out):
            self._out = ctypes.create_string_buffer(
                max(need, 2 * len(self._out)))
        w = self._lib.cl_aead_seal_frames(
            self._h, data, n, chunk, 1 if with_eof else 0, self._out,
            len(self._out))
        if w < 0:
            raise RuntimeError("native seal capacity error")
        # string_at copies exactly w bytes (.raw would copy the buffer).
        return ctypes.string_at(self._out, w)

    def open(self, ct: bytes) -> bytes | None:
        """Open one ciphertext frame body (no length prefix): the
        plaintext, or None on an authentication failure.  The counter
        advances either way, as the Python ``SecureReader``'s does."""
        n = len(ct)
        if n - TAG_LEN > len(self._pt):
            self._pt = ctypes.create_string_buffer(max(n, 2 * len(self._pt)))
        r = self._lib.cl_aead_open(self._h, ct, n, self._pt, len(self._pt))
        if r == -1:
            return None
        if r < 0:
            raise RuntimeError("native open capacity error")
        return ctypes.string_at(self._pt, r)


def seal_raw(key: bytes, nonce: bytes, pt: bytes, aad: bytes = b"") -> bytes:
    """One-shot ChaCha20-Poly1305 seal with an explicit nonce and aad
    (ct || tag), for pinning the core to RFC 8439 vectors."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = ctypes.create_string_buffer(len(pt) + TAG_LEN)
    n = lib.cl_aead_seal_raw(key, nonce, aad, len(aad), pt, len(pt), out,
                             len(out))
    if n < 0:
        raise RuntimeError("native seal capacity error")
    return ctypes.string_at(out, n)
