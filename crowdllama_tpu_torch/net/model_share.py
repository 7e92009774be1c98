"""Swarm model sharing: peer-to-peer checkpoint transfer.

Counterpart of ``crowdllama_tpu/net/model_share.py``, on the same wire
(``MODEL_PROTOCOL``, one JSON-framed request per authenticated stream,
the same frames and bytes), so a torch worker and a JAX worker share
checkpoints with each other.  A worker that serves a model from a local
checkpoint directory shares it; a worker that wants it streams the files
from a DHT-discovered peer with per-file SHA-256 verification, then
hot-registers the model (``MultiEngine.add_model``).

Wire ops:

- ``manifest`` {model} -> {files: [{name, size, sha256}]}
- ``fetch``    {model, name} -> {size} + the file's raw bytes
- ``pull``     {model} -> asks this worker to acquire the model from the
  swarm and serve it (the gateway's /api/pull proxies here)

Only checkpoint-shaped files are served (config/tokenizer json,
safetensors and their index: the ``_SHAREABLE`` allow-list), and model
names are validated (``safe_model_dirname``): a manifest or a name cannot
point outside the checkpoint or the models directory.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import re
import shutil
from pathlib import Path

from crowdllama_tpu_torch.core.protocol import MODEL_PROTOCOL
from crowdllama_tpu_torch.net.host import (
    Contact,
    Host,
    Stream,
    read_json_frame,
    write_json_frame,
)

log = logging.getLogger("crowdllama.torch.net.model_share")

CHUNK = 256 * 1024
OP_TIMEOUT = 30.0
# Manifest hashing digests whole checkpoints (minutes for tens of GB on a
# cold cache) — the client must out-wait it.
MANIFEST_TIMEOUT = 900.0
FETCH_IDLE_TIMEOUT = 60.0
MAX_FILE_BYTES = 64 * 1024 ** 3  # sanity cap (a 70B int8 shard is ~35 GB)

#: checkpoint files eligible for transfer (allow-list, not a deny-list)
_SHAREABLE = (
    "config.json", "generation_config.json", "model.safetensors.index.json",
    "tokenizer.json", "tokenizer_config.json", "tokenizer.model",
    "special_tokens_map.json",
)


#: one HF-style name segment: must start alphanumeric (no dotfiles, no
#: "."/".."), then alnum/dot/dash/underscore only — no separators.
_SEGMENT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


def safe_model_dirname(model: str) -> str:
    """Validate a (possibly remote-supplied) model name and return the
    directory name it maps to under the models dir.

    Model names reach this code from untrusted peers (the gateway's
    /api/pull proxies any client string to a worker's MODEL_PROTOCOL
    ``pull`` op), and the fetch path rmtree's/renames ``dest`` — so a name
    like ``.`` or ``..`` must never resolve to the models root or above it.
    Accepts HF-style ``org/name`` (each segment validated separately);
    rejects empty/overlong names, backslashes, and any segment that is
    ``.``, ``..``, or starts with a dot."""
    if not model or len(model) > 256 or "\\" in model:
        raise ValueError(f"invalid model name {model!r}")
    segs = model.split("/")
    if not all(_SEGMENT_RE.match(s) for s in segs):
        raise ValueError(f"invalid model name {model!r}")
    return "_".join(segs)


def dest_under_root(dest_root: str | Path, model: str) -> Path:
    """``dest_root/<flattened model>`` with a belt-and-braces containment
    assert (the dirname is already regex-validated).  The one resolver for
    models-dir paths — fetch, rm, show all go through it."""
    root = Path(dest_root).expanduser().resolve()
    dest = (root / safe_model_dirname(model)).resolve()
    if dest.parent != root or dest == root:
        raise ValueError(f"model name {model!r} escapes models dir")
    return dest


def _shareable(name: str) -> bool:
    if "/" in name or "\\" in name or name.startswith(".") or ".." in name:
        return False
    return name in _SHAREABLE or name.endswith(".safetensors")


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with path.open("rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
    return h.hexdigest()


#: per-checkpoint integrity record written at promote time — the digests
#: the wire transfer verified, persisted so a CACHED checkpoint can be
#: re-verified before load (a half-written disk, bit rot, or a concurrent
#: writer corrupts silently otherwise).  Dotfile: _shareable() rejects it,
#: so it can never be served or fetched as checkpoint content.
MANIFEST_NAME = ".crowdllama_manifest.json"


def write_cache_manifest(dest: Path, files: list[dict]) -> None:
    """Persist the verified per-file digests next to the checkpoint."""
    record = [{"name": str(f["name"]), "size": int(f["size"]),
               "sha256": str(f["sha256"])} for f in files]
    (dest / MANIFEST_NAME).write_text(
        json.dumps({"files": record}, indent=0))


def verify_cached(dest: str | Path) -> bool:
    """Re-verify a cached checkpoint against its promote-time manifest.

    True when every recorded file matches its digest, or when there is no
    manifest at all (a locally-provisioned checkpoint predating the
    record — nothing to verify against).  False on any mismatch or
    missing file: the caller must evict and refetch."""
    dest = Path(dest)
    mpath = dest / MANIFEST_NAME
    if not mpath.exists():
        return True
    try:
        record = json.loads(mpath.read_text()).get("files") or []
    except (ValueError, OSError):
        return False
    for f in record:
        p = dest / str(f.get("name", ""))
        if not p.is_file() or p.stat().st_size != int(f.get("size", -1)):
            return False
        if _sha256_file(p) != str(f.get("sha256", "")):
            return False
    return True


async def ensure_model(host: Host, source: Contact, model: str,
                       dest_root: str | Path) -> Path:
    """Cached-or-fetch: return a VERIFIED local checkpoint dir for
    ``model``, re-downloading when the cache is absent or fails its
    manifest check (corrupt artifacts are evicted, never loaded)."""
    dest = dest_under_root(dest_root, model)
    if dest.is_dir():
        ok = await asyncio.to_thread(verify_cached, dest)
        if ok:
            return dest
        log.warning("cached checkpoint %s failed sha256 verification; "
                    "evicting and refetching", dest)
        await asyncio.to_thread(shutil.rmtree, dest, ignore_errors=True)
    return await fetch_model(host, source, model, dest_root)


class ModelShareService:
    """Serves this worker's checkpoints and handles pull triggers.

    ``model_dir(model)`` and ``pull(model)`` come from the owning Peer —
    the service itself is transport only."""

    def __init__(self, model_dir, pull=None, allow_pull: bool = True):
        self._model_dir = model_dir          # (model) -> Path | None
        self._pull = pull                    # async (model) -> str | None
        self._allow_pull = allow_pull
        # One swarm-triggered pull at a time: a hostile peer spamming the
        # op must not fan out N concurrent multi-GB downloads.
        self._pull_lock = asyncio.Lock()
        # (path, size, mtime_ns) -> sha256: checkpoints are immutable in
        # practice; re-hashing tens of GB per manifest request would burn
        # minutes of CPU per pull attempt.
        self._hash_cache: dict[tuple, str] = {}

    async def handle(self, stream: Stream) -> None:
        try:
            req = await read_json_frame(stream.reader, OP_TIMEOUT)
            op = str(req.get("op", ""))
            model = str(req.get("model", ""))
            try:
                safe_model_dirname(model)
            except ValueError as e:
                await write_json_frame(stream.writer,
                                       {"ok": False, "error": str(e)})
                return
            if op == "manifest":
                await self._manifest(stream, model)
            elif op == "fetch":
                await self._fetch(stream, model, str(req.get("name", "")))
            elif op == "pull" and self._pull is not None:
                if not self._allow_pull:
                    await write_json_frame(stream.writer, {
                        "ok": False,
                        "error": "swarm-triggered pulls disabled on this "
                                 "worker (CROWDLLAMA_TPU_ALLOW_SWARM_PULL)"})
                    return
                if self._pull_lock.locked():
                    await write_json_frame(stream.writer, {
                        "ok": False, "error": "a pull is already running"})
                    return
                try:
                    async with self._pull_lock:
                        path = await self._pull(model)
                    await write_json_frame(stream.writer,
                                           {"ok": True, "path": str(path)})
                except Exception as e:
                    await write_json_frame(stream.writer,
                                           {"ok": False, "error": str(e)})
            else:
                await write_json_frame(
                    stream.writer, {"ok": False, "error": f"unknown op {op!r}"})
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.debug("model share stream failed: %s", e)
        finally:
            stream.close()

    def _dir_for(self, model: str) -> Path | None:
        d = self._model_dir(model)
        if d is None:
            return None
        d = Path(d).expanduser()
        return d if d.is_dir() and list(d.glob("*.safetensors")) else None

    async def _manifest(self, stream: Stream, model: str) -> None:
        d = self._dir_for(model)
        if d is None:
            await write_json_frame(stream.writer, {
                "ok": False,
                "error": f"no shareable checkpoint for {model!r} here"})
            return
        loop = asyncio.get_running_loop()
        files = []
        for p in sorted(d.iterdir()):
            if p.is_file() and _shareable(p.name):
                st = p.stat()
                cache_key = (str(p), st.st_size, st.st_mtime_ns)
                digest = self._hash_cache.get(cache_key)
                if digest is None:
                    # Hash off-loop: a 16 GB shard takes a while to digest.
                    digest = await loop.run_in_executor(None, _sha256_file, p)
                    self._hash_cache[cache_key] = digest
                files.append({"name": p.name, "size": st.st_size,
                              "sha256": digest})
        await write_json_frame(stream.writer, {"ok": True, "files": files})

    async def _fetch(self, stream: Stream, model: str, name: str) -> None:
        d = self._dir_for(model)
        if d is None or not _shareable(name) or not (d / name).is_file():
            await write_json_frame(stream.writer, {
                "ok": False, "error": f"no file {name!r} for model {model!r}"})
            return
        path = d / name
        size = path.stat().st_size
        await write_json_frame(stream.writer, {"ok": True, "size": size})
        loop = asyncio.get_running_loop()
        with path.open("rb") as f:
            while True:
                chunk = await loop.run_in_executor(None, f.read, CHUNK)
                if not chunk:
                    break
                stream.writer.write(chunk)
                await stream.writer.drain()


async def fetch_model(host: Host, source: Contact, model: str,
                      dest_root: str | Path) -> Path:
    """Download ``model``'s checkpoint from ``source`` into
    ``dest_root/<model>/``; every file is SHA-256-verified against the
    manifest before the function returns.  Partial downloads live in a
    ``.partial`` staging dir so a crash never leaves a plausible-looking
    but corrupt checkpoint.  The model name is validated (it may come from
    an untrusted peer via the ``pull`` op) so ``dest`` can never resolve to
    the models root or escape it."""
    dest = dest_under_root(dest_root, model)
    staging = dest.with_name(dest.name + ".partial")
    if staging.exists():
        # A dirty staging dir from an aborted pull must not leak stale
        # (unverified) shards into the promoted checkpoint.  rmtree over
        # a multi-GB half-pull blocks for seconds — keep it off the loop.
        await asyncio.to_thread(shutil.rmtree, staging)
    staging.mkdir(parents=True)

    stream = await host.new_stream(source, MODEL_PROTOCOL)
    try:
        await write_json_frame(stream.writer,
                               {"op": "manifest", "model": model})
        reply = await read_json_frame(stream.reader, MANIFEST_TIMEOUT)
    finally:
        stream.close()
    if not reply.get("ok"):
        raise RuntimeError(f"manifest failed: {reply.get('error')}")
    files = reply.get("files") or []
    if not any(f["name"].endswith(".safetensors") for f in files):
        raise RuntimeError(f"source has no safetensors for {model!r}")
    total = sum(int(f.get("size", 0)) for f in files)
    free = shutil.disk_usage(staging).free
    if total * 1.05 + (256 << 20) > free:
        await asyncio.to_thread(shutil.rmtree, staging, ignore_errors=True)
        raise RuntimeError(
            f"not enough disk for {model!r}: need {total} bytes, "
            f"{free} free under {staging.parent}")

    for f in files:
        name, size, want = str(f["name"]), int(f["size"]), str(f["sha256"])
        if not _shareable(name) or not (0 <= size <= MAX_FILE_BYTES):
            raise RuntimeError(f"refusing manifest entry {name!r}")
        stream = await host.new_stream(source, MODEL_PROTOCOL)
        try:
            await write_json_frame(stream.writer,
                                   {"op": "fetch", "model": model,
                                    "name": name})
            head = await read_json_frame(stream.reader, OP_TIMEOUT)
            if not head.get("ok"):
                raise RuntimeError(f"fetch {name}: {head.get('error')}")
            if int(head.get("size", -1)) != size:
                raise RuntimeError(f"fetch {name}: size changed mid-transfer")
            h = hashlib.sha256()
            with (staging / name).open("wb") as out:
                remaining = size
                while remaining > 0:
                    chunk = await asyncio.wait_for(
                        stream.reader.read(min(CHUNK, remaining)),
                        FETCH_IDLE_TIMEOUT)
                    if not chunk:
                        raise RuntimeError(f"fetch {name}: stream truncated")
                    out.write(chunk)
                    h.update(chunk)
                    remaining -= len(chunk)
            if h.hexdigest() != want:
                raise RuntimeError(f"fetch {name}: sha256 mismatch")
        finally:
            stream.close()
        log.info("pulled %s/%s (%d bytes, verified)", model, name, size)

    # Atomic-ish promote: all files verified, swap staging into place.
    # The manifest rides along so verify_cached() can re-check the
    # artifact on every later cache hit (draft-checkpoint loads included).
    write_cache_manifest(staging, files)
    if dest.exists():
        await asyncio.to_thread(shutil.rmtree, dest)
    staging.rename(dest)
    return dest


async def request_pull(host: Host, worker: Contact, model: str,
                       timeout: float = 600.0) -> str:
    """Ask a REMOTE worker to pull ``model`` from the swarm and serve it
    (the gateway's /api/pull proxy path)."""
    stream = await host.new_stream(worker, MODEL_PROTOCOL)
    try:
        await write_json_frame(stream.writer, {"op": "pull", "model": model})
        reply = await read_json_frame(stream.reader, timeout)
        if not reply.get("ok"):
            raise RuntimeError(str(reply.get("error", "pull failed")))
        return str(reply.get("path", ""))
    finally:
        stream.close()
