"""Mesh specs and the tensor-parallel device list.

Counterpart of ``crowdllama_tpu/parallel/mesh.py``: the same spec strings
("A" -> tp=A; "AxB" -> dp=A, tp=B; "AxBxC" -> dp=A, ep=B, tp=C;
"AxBxCxD" -> dp=A, sp=B, ep=C, tp=D; "AxBxCxDxE" -> dp=A, pp=B, sp=C,
ep=D, tp=E) and the same automatic choices (:func:`largest_tp`,
:func:`choose_mesh_shape`).

Every in-mesh axis in the port is single-controller, as in the JAX
package: one process drives every rank.  A :class:`Mesh` is therefore a
record, not a communicator: the axis sizes and the device of each rank,
the ranks in the row-major order of JAX's device array (tp fastest, then
ep, sp, pp, dp), with each rank's (dp, pp, sp, ep, tp) coordinates
(:meth:`Mesh.coords`) and the ranks along one axis
(:meth:`Mesh.ranks_along`).  Each rank's weights, KV cache or pools and
scales live on its device; the collectives GSPMD and ``shard_map``
derive are written out in ``parallel/sharding.py``, ``ops/ring.py`` and
``parallel/pipeline.py``.  The default device list is the visible CUDA
devices, each once; an explicit list may name one device several times
(virtual ranks, as the JAX tests place shards on virtual CPU devices,
or every rank on one card).

A mesh may span processes (``parallel/multihost.py``): JAX orders the
global devices by process, so in a mesh of ``n`` processes process ``p``
holds the row-major ranks ``[p*L, (p+1)*L)``, ``L = size / n``, on its
own devices; :attr:`Mesh.devices` are those local ranks' devices,
:meth:`Mesh.process_of` names a rank's process and
:attr:`Mesh.local_ranks` this process's ranks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

AXIS_DP, AXIS_PP, AXIS_SP, AXIS_EP, AXIS_TP = "dp", "pp", "sp", "ep", "tp"
AXES = (AXIS_DP, AXIS_PP, AXIS_SP, AXIS_EP, AXIS_TP)


def mesh_axes(spec: str) -> tuple[int, int, int, int, int] | None:
    """The (dp, pp, sp, ep, tp) a non-empty spec names (None for ""),
    without checking it against a device count."""
    if not spec:
        return None
    parts = [int(p) for p in spec.lower().replace("x", " ").split()]
    if len(parts) == 1:
        return (1, 1, 1, 1, parts[0])
    if len(parts) == 2:
        return (parts[0], 1, 1, 1, parts[1])
    if len(parts) == 3:
        return (parts[0], 1, 1, parts[1], parts[2])
    if len(parts) == 4:
        return (parts[0], 1, parts[1], parts[2], parts[3])
    if len(parts) == 5:
        return tuple(parts)
    raise ValueError(f"bad mesh spec {spec!r}")


def parse_mesh_spec(spec: str, n_devices: int) -> tuple[int, int, int, int, int]:
    """Parse "AxB..." into a (dp, pp, sp, ep, tp) shape; "" is tp over
    every device.  Raises ``ValueError`` when the shape needs more devices
    than ``n_devices``."""
    shape = mesh_axes(spec)
    if shape is None:
        return (1, 1, 1, 1, n_devices)
    if math.prod(shape) > n_devices:
        raise ValueError(
            f"mesh spec {spec!r} = {shape} needs {math.prod(shape)} devices, "
            f"have {n_devices}")
    return shape


def largest_tp(n_devices: int, num_kv_heads: int) -> int:
    """Largest tensor-parallel degree dividing both the device count and the
    kv-head count (the KV pools shard kv heads over tp)."""
    for cand in range(min(n_devices, num_kv_heads), 0, -1):
        if n_devices % cand == 0 and num_kv_heads % cand == 0:
            return cand
    return 1


def choose_mesh_shape(n_devices: int, num_kv_heads: int,
                      num_experts: int = 0) -> tuple[int, int, int, int, int]:
    """Pick (dp, pp, sp, ep, tp) automatically: as much tp as kv-head
    divisibility allows, the rest to ep (MoE) or dp."""
    tp = largest_tp(n_devices, num_kv_heads)
    rest = n_devices // tp
    if num_experts and num_experts % rest == 0:
        return (1, 1, 1, rest, tp)
    return (rest, 1, 1, 1, tp)


def visible_devices() -> list[torch.device]:
    """The visible CUDA devices, each once (never the CPU)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclass(frozen=True)
class Mesh:
    """Axis sizes and the devices of this process's ranks, one a rank in
    (dp, pp, sp, ep, tp) row-major order (every rank in one process);
    with only tp > 1 the devices are the tp ranks."""

    shape: tuple[int, int, int, int, int]
    devices: tuple[torch.device, ...]
    n_processes: int = 1
    process_index: int = 0

    @property
    def local_size(self) -> int:
        """L: the ranks each process holds."""
        return self.size // self.n_processes

    @property
    def local_ranks(self) -> range:
        """This process's global ranks."""
        first = self.process_index * self.local_size
        return range(first, first + self.local_size)

    def process_of(self, rank: int) -> int:
        """The process that holds global rank ``rank``."""
        return rank // self.local_size

    def is_local(self, rank: int) -> bool:
        return self.process_of(rank) == self.process_index

    @property
    def axes(self) -> dict[str, int]:
        return dict(zip(AXES, self.shape))

    @property
    def dp(self) -> int:
        return self.shape[0]

    @property
    def pp(self) -> int:
        return self.shape[1]

    @property
    def sp(self) -> int:
        return self.shape[2]

    @property
    def ep(self) -> int:
        return self.shape[3]

    @property
    def tp(self) -> int:
        return self.shape[-1]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coords(self, rank: int) -> tuple[int, int, int, int, int]:
        """Rank ``rank``'s (dp, pp, sp, ep, tp) coordinates (row-major,
        as ``np.unravel_index`` over the shape)."""
        out = []
        for n in reversed(self.shape):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def rank(self, dp: int = 0, pp: int = 0, sp: int = 0, ep: int = 0,
             tp: int = 0) -> int:
        """The rank at these coordinates."""
        r = 0
        for c, n in zip((dp, pp, sp, ep, tp), self.shape):
            if not 0 <= c < n:
                raise ValueError(f"coordinate {c} outside an axis of {n}")
            r = r * n + c
        return r

    def ranks_along(self, axis: str, **fixed: int) -> list[int]:
        """The ranks along ``axis``, in order, with the other coordinates
        ``fixed`` (0 where not given)."""
        i = AXES.index(axis)
        return [self.rank(**{**fixed, axis: c}) for c in range(self.shape[i])]

    def device(self, **coords: int) -> torch.device:
        """The device of the rank at ``coords`` (0 where not given), which
        this process must hold."""
        return self.rank_device(self.rank(**coords))

    def rank_device(self, rank: int) -> torch.device:
        """The device of global rank ``rank``, which this process holds."""
        if not self.is_local(rank):
            raise ValueError(f"rank {rank} lives in process "
                             f"{self.process_of(rank)}, not in process "
                             f"{self.process_index}")
        return self.devices[rank - self.local_ranks.start]

    @classmethod
    def single(cls, device: torch.device) -> "Mesh":
        return cls((1, 1, 1, 1, 1), (device,))


def build_mesh(spec: str = "", devices: list | None = None,
               processes: tuple[int, int] | None = None) -> Mesh:
    """Build the mesh ``spec`` names over ``devices`` (default: the visible
    CUDA devices); a spec smaller than the device list takes a prefix of
    it.  ``devices`` may repeat a device.

    ``processes`` is (process count, this process's index), by default
    the running ``torch.distributed`` group's (``parallel/multihost.py``;
    (1, 0) without one).  Across ``n`` processes ``devices`` are this
    process's: the mesh's size must divide by ``n``, and the process
    places its ``size / n`` ranks on a prefix of them."""
    if processes is None:
        from crowdllama_tpu_torch.parallel import multihost

        processes = (multihost.process_count(), multihost.process_index())
    n, p = processes
    devs = [torch.device(d) for d in
            (devices if devices is not None else visible_devices())]
    shape = parse_mesh_spec(spec, len(devs) * n)
    if not devs:
        raise ValueError("no devices for the mesh (no CUDA device visible; "
                         "pass devices= to place the shards)")
    size = math.prod(shape)
    if size % n:
        raise ValueError(f"mesh {shape} of {size} ranks does not split over "
                         f"{n} processes")
    return Mesh(shape, tuple(devs[:size // n]), n, p)
