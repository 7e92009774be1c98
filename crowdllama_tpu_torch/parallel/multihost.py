"""Multi-process serving: one logical worker over several processes.

Counterpart of ``crowdllama_tpu/parallel/multihost.py``.  The JAX package
spans hosts through ``jax.distributed``: after it, every mesh builder sees
the global device list and XLA partitions the collectives.  The port
spans processes through ``torch.distributed``: each process holds the
mesh ranks of its own devices (``parallel/mesh.py``: process ``p`` holds
the row-major global ranks ``[p*L, (p+1)*L)``), and the collectives the
ranks of one axis need across processes are written out here.

The driving model is JAX's leader-replicated dispatch
(``parallel/replicated.py``): process 0 runs the public surfaces and makes
every admission decision, every process issues the same runner calls in
the same order, and the host inputs of each call are broadcast from
process 0 (:func:`broadcast_from_leader`) before it.

Process groups, chosen once at start and logged:

- frames (:func:`broadcast_from_leader`: headers and their prompts) ride
  a gloo group of their own, whose timeout is long: a follower waits
  there for the leader's next call however long the worker stays idle;
- the other host collectives (the decode readback's
  :func:`process_allgather`, :func:`barrier`) ride the default gloo
  group, whose timeout
  (``timeout_s`` of :func:`initialize_from_config`) fails a collective
  whose peer hangs; a peer that dies fails it at once (its sockets
  close);
- the device collectives of a mesh axis that crosses processes
  (:func:`axis_comm`) take NCCL when the processes hold distinct CUDA
  devices, and gloo when any two of them share a device (NCCL refuses
  two ranks on one GPU) or the ranks sit on the CPU
  (:func:`device_backend`).  The rule is decided from the devices, never
  by trying NCCL first.  The device collectives are ``all_reduce``,
  ``all_gather`` and ``broadcast`` (:class:`AxisComm`), which both
  backends take on CUDA tensors, so no tensor is staged through the host
  for them; a CUDA tensor handed to a host collective is copied to the
  host explicitly, and each such copy is counted
  (``stats()["host_copies"]``).

Counters (:func:`stats`, :func:`reset_stats`): frames and their bytes and
host seconds, host gathers, device collectives and their bytes and
seconds (device time between CUDA events on CUDA tensors, so timing puts
no host wait on the hot path; host time on the CPU).
"""

from __future__ import annotations

import collections
import datetime
import hashlib
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger("crowdllama.torch.parallel.multihost")

#: seconds a data collective waits for a peer before it fails
DEFAULT_TIMEOUT_S = 120.0
#: seconds a follower waits for the leader's next frame (an idle worker)
FRAME_TIMEOUT_S = 30 * 24 * 3600.0

_GROUPS: dict = {}   # (ranks, backend) -> process group
_FRAME_GROUP = None
_BACKEND: dict = {}  # devices key -> backend
_STATS = dict(frames=0, frame_bytes=0, frame_s=0.0, gathers=0,
              gather_bytes=0, gather_s=0.0, device_calls=0, device_bytes=0,
              device_s=0.0, host_copies=0)
#: (start, end) CUDA events of the device collectives not yet read
_EVENTS: collections.deque = collections.deque()


def _dist():
    import torch.distributed as dist

    return dist


def initialize_from_config(config, timeout_s: float = DEFAULT_TIMEOUT_S
                           ) -> bool:
    """``torch.distributed.init_process_group`` (gloo) from the
    Configuration's ``dist_coordinator`` ("host:port" of process 0),
    ``dist_num_processes`` and ``dist_process_id``; returns True when
    multi-process mode is active, False when no coordinator is set.

    ``dist_num_processes`` 0 and ``dist_process_id`` -1 mean "inferred",
    as in JAX: they are read from ``WORLD_SIZE`` / ``RANK``, and a missing
    one raises ``ValueError`` (never a guess).  A second call in the same
    process is tolerated when it names the same process."""
    coord = getattr(config, "dist_coordinator", "")
    if not coord:
        return False
    n = int(getattr(config, "dist_num_processes", 0) or 0)
    pid = int(getattr(config, "dist_process_id", -1))
    if n <= 0:
        if "WORLD_SIZE" not in os.environ:
            raise ValueError("dist_num_processes is 0 and WORLD_SIZE is not "
                             "set: the process count cannot be inferred")
        n = int(os.environ["WORLD_SIZE"])
    if pid < 0:
        if "RANK" not in os.environ:
            raise ValueError("dist_process_id is -1 and RANK is not set: "
                             "the process id cannot be inferred")
        pid = int(os.environ["RANK"])
    if not 0 <= pid < n:
        raise ValueError(f"dist_process_id {pid} outside [0, {n})")
    dist = _dist()
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (n, pid):
            raise RuntimeError(
                f"torch.distributed already initialized as process "
                f"{dist.get_rank()}/{dist.get_world_size()}, asked for "
                f"{pid}/{n}")
        log.debug("torch.distributed already initialized")
        return True
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coord}", world_size=n, rank=pid,
        timeout=datetime.timedelta(seconds=timeout_s))
    _frame_group()  # a collective: made here, in the same order everywhere
    log.info("multi-process: process %d/%d (coordinator %s)", pid, n, coord)
    return True


def process_count() -> int:
    """The number of processes of this worker (1 when no group is up)."""
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def is_leader() -> bool:
    """True on process 0 (or in single-process mode): the process that
    owns the gateway, peer and scheduler surfaces."""
    return process_index() == 0


def stats() -> dict:
    """The collective counters since the last :func:`reset_stats` (waits
    for the device collectives still running, to read their time)."""
    _fold_events(block=True)
    return dict(_STATS)


def reset_stats() -> None:
    _EVENTS.clear()
    for k, v in _STATS.items():
        _STATS[k] = type(v)()


def _frame_group():
    """The gloo group frames ride (a long timeout: an idle follower)."""
    global _FRAME_GROUP
    if _FRAME_GROUP is None:
        _FRAME_GROUP = _dist().new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=FRAME_TIMEOUT_S))
    return _FRAME_GROUP


def _host(x) -> np.ndarray:
    """``x`` as a host array; a CUDA tensor is copied (and counted)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            _STATS["host_copies"] += 1
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(value) -> list:
    if isinstance(value, dict):
        return [_host(value[k]) for k in sorted(value)]
    return [_host(value)]


def broadcast_from_leader(value):
    """Replicate a host payload from process 0 to every process: an array
    (numpy or a tensor) or a dict of them, of shapes and dtypes both sides
    derive alike (the follower passes a template of zeros).  The leaves
    travel as one byte buffer in one gloo broadcast (fixed shapes, no
    pickling, as JAX's ``broadcast_one_to_all``).  Returns the leader's
    value with the template's structure (numpy arrays).  No-op in
    single-process mode."""
    if process_count() == 1:
        return value
    dist = _dist()
    leaves = _leaves(value)
    flat = [np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            for a in leaves]
    buf = torch.from_numpy(np.concatenate(flat) if flat
                           else np.zeros((0,), np.uint8)).clone()
    t0 = time.perf_counter()
    dist.broadcast(buf, src=0, group=_frame_group())
    _STATS["frame_s"] += time.perf_counter() - t0
    _STATS["frames"] += 1
    _STATS["frame_bytes"] += buf.numel()
    raw, out, pos = buf.numpy(), [], 0
    for a in leaves:
        n = a.nbytes
        out.append(raw[pos:pos + n].view(a.dtype).reshape(a.shape).copy())
        pos += n
    if isinstance(value, dict):
        return dict(zip(sorted(value), out))
    return out[0]


def process_allgather(x, tiled: bool = True) -> np.ndarray:
    """Every process's ``x`` (equal shapes), in process order: stacked on
    a new leading axis, or with ``tiled`` concatenated along axis 0 (JAX's
    ``process_allgather``).  Host data over the default gloo group."""
    a = _host(x)
    if process_count() == 1:
        return a if tiled else a[None]
    dist = _dist()
    src = torch.from_numpy(np.ascontiguousarray(a)).clone()
    parts = [torch.empty_like(src) for _ in range(process_count())]
    t0 = time.perf_counter()
    dist.all_gather(parts, src)
    _STATS["gather_s"] += time.perf_counter() - t0
    _STATS["gathers"] += 1
    _STATS["gather_bytes"] += src.numel() * src.element_size() * len(parts)
    out = np.stack([p.numpy() for p in parts])
    return out.reshape(-1, *a.shape[1:]) if tiled else out


def barrier(name: str = "crowdllama") -> None:
    """Block until every process reaches this point."""
    if process_count() == 1:
        return
    log.debug("barrier %s", name)
    _dist().barrier()


# ------------------------------------------------------ device collectives

def _device_id(d: torch.device) -> int:
    """A 63-bit id of the physical device ``d`` (its UUID on CUDA), or -1
    for a CPU rank."""
    if d.type != "cuda":
        return -1
    props = torch.cuda.get_device_properties(
        d.index if d.index is not None else torch.cuda.current_device())
    uuid = str(getattr(props, "uuid", "")) or f"{props.name}:{d.index}"
    return int.from_bytes(hashlib.sha256(uuid.encode()).digest()[:8],
                          "big") >> 1


def device_backend(devices) -> str:
    """The backend of the device collectives for a mesh whose local ranks
    sit on ``devices`` (the same count in every process): "nccl" when
    every process's ranks sit on CUDA devices that no other process
    holds, else "gloo" (processes share a device, which NCCL refuses, or
    the ranks are on the CPU).  Decided once per device list from every
    process's device ids (a collective) and logged."""
    key = tuple(str(d) for d in devices)
    if key in _BACKEND:
        return _BACKEND[key]
    ids = np.array([_device_id(torch.device(d)) for d in devices], np.int64)
    every = process_allgather(ids[None], tiled=False)[:, 0]   # [n, L]
    if (every < 0).any():
        backend, why = "gloo", "ranks on the CPU"
    else:
        owners: dict = {}
        for p, row in enumerate(every):
            for i in set(row.tolist()):
                owners.setdefault(i, set()).add(p)
        shared = any(len(ps) > 1 for ps in owners.values())
        backend, why = (("gloo", "processes share a CUDA device") if shared
                        else ("nccl", "each process holds its own CUDA "
                              "devices"))
    log.info("multi-process: device collectives over %s (%s)", backend, why)
    _BACKEND[key] = backend
    return backend


def _group(ranks: tuple[int, ...], backend: str):
    """The process group of ``ranks`` (every process calls this for every
    group, in the same order, as ``new_group`` requires)."""
    key = (ranks, backend)
    if key not in _GROUPS:
        _GROUPS[key] = _dist().new_group(list(ranks), backend=backend)
    return _GROUPS[key]


class AxisComm:
    """The cross-process half of one mesh axis's collectives: the group
    of the processes that hold ranks of this process's axis group, in
    process order (``processes``; ``index`` is this process's place
    there).  ``offset`` is how many of the axis's ranks lie in earlier
    processes (where this process's ranks start along the axis), ``size``
    the axis's rank count; each process holds ``size /
    len(processes)`` of them (a process's ranks are a box of the mesh).

    Every operation is one collective over the group, which every member
    must make, in the same order: :meth:`all_reduce` (the tp sums, the
    ep combine), :meth:`all_gather` (the sp blocks and partial softmax
    sums, the pp hand-off) and :meth:`broadcast` (the last pp stage's
    activations).  The gather and the broadcast move the tensor's bytes
    (any dtype, exact); the sum takes the tensor's own dtype."""

    def __init__(self, group, processes: tuple[int, ...], offset: int,
                 size: int, backend: str, index: int):
        self.group = group
        self.processes = processes
        self.offset = offset
        self.size = size
        self.backend = backend
        self.index = index

    @property
    def local(self) -> int:
        """The axis's ranks each member process holds."""
        return self.size // len(self.processes)

    def _timed(self, t: torch.Tensor, nbytes: int, op) -> None:
        """Run the collective ``op()`` on ``t``'s device and count it.  On
        CUDA it is timed by two events on the current stream (read in
        :func:`stats`), so the host never waits for it here."""
        if t.device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            op()
            ev[1].record()
            _EVENTS.append(ev)
            if len(_EVENTS) > 256:
                _fold_events(block=False)
        else:
            t0 = time.perf_counter()
            op()
            _STATS["device_s"] += time.perf_counter() - t0
        _STATS["device_calls"] += 1
        _STATS["device_bytes"] += nbytes

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group's processes, in place; returns it."""
        self._timed(t, t.numel() * t.element_size(),
                    lambda: _dist().all_reduce(t, group=self.group))
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every member's ``t`` (the same shape and dtype everywhere), in
        member order, on ``t``'s device: bit for bit what each sent."""
        buf = _as_bytes(t)
        parts = [torch.empty_like(buf) for _ in self.processes]
        self._timed(t, buf.numel() * len(parts),
                    lambda: _dist().all_gather(parts, buf, group=self.group))
        return [p.view(t.dtype).view(t.shape) for p in parts]

    def broadcast(self, t: torch.Tensor, member: int) -> torch.Tensor:
        """``t`` as member ``member`` holds it, written into ``t`` in
        place on every member; returns it."""
        buf = _as_bytes(t)
        src = self.processes[member]
        self._timed(t, buf.numel(),
                    lambda: _dist().broadcast(buf, src=src, group=self.group))
        if buf.data_ptr() != t.data_ptr():
            t.copy_(buf.view(t.dtype).view(t.shape))
        return t


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor (a view when ``t`` is
    contiguous): every backend moves uint8, whatever ``t``'s dtype."""
    return t.contiguous().view(-1).view(torch.uint8)


def _fold_events(block: bool) -> None:
    """Add the timed device collectives whose end event has completed (all
    of them with ``block``) to ``device_s``."""
    while _EVENTS:
        start, end = _EVENTS[0]
        if block:
            end.synchronize()
        elif not end.query():
            return
        _STATS["device_s"] += start.elapsed_time(end) / 1e3
        _EVENTS.popleft()


def axis_comm(mesh, axis_ranks: list[list[int]], devices) -> AxisComm | None:
    """The :class:`AxisComm` of this process's group along one axis, or
    None when no group of the axis crosses processes.  ``axis_ranks`` is
    every group of the axis (each a list of global ranks, in axis order),
    the same list in every process; ``devices`` this process's local
    devices (for :func:`device_backend`)."""
    per_group = []
    for ranks in axis_ranks:
        procs = tuple(sorted({mesh.process_of(r) for r in ranks}))
        per_group.append((ranks, procs))
    if all(len(p) == 1 for _, p in per_group):
        return None
    backend = device_backend(devices)
    mine = None
    for ranks, procs in per_group:
        if len(procs) == 1:
            continue
        g = _group(procs, backend)
        if mesh.process_index in procs:
            offset = sum(1 for r in ranks
                         if mesh.process_of(r) < mesh.process_index)
            mine = AxisComm(g, procs, offset, len(ranks), backend,
                            procs.index(mesh.process_index))
    return mine
