"""Peer capability metadata (``Resource``).

Counterpart of ``crowdllama_tpu/core/resource.py``: the JSON blob a peer
serves over the metadata stream protocol and the DHT ``metadata`` op,
whose freshness gates discovery and health.  The keys are the JAX
package's (a JAX gateway parses them); a torch worker fills
``gpu_model`` / ``vram_gb`` and ``accelerator`` from ``torch.cuda`` and
leaves the TPU-only fields at their defaults.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any


@dataclass
class ShardGroup:
    """Membership of a multi-worker sharded-model group."""

    group_id: str = ""
    model: str = ""
    strategy: str = ""  # "ep" | "tp" | "pp"
    shard_index: int = 0
    shard_count: int = 1
    expert_ids: list[int] = field(default_factory=list)


@dataclass
class Resource:
    """Worker/consumer capability advertisement."""

    peer_id: str = ""
    supported_models: list[str] = field(default_factory=list)
    tokens_throughput: float = 0.0  # tokens/sec
    load: float = 0.0  # 0..1 utilization of decode slots
    last_updated: float = 0.0  # unix seconds
    version: str = ""
    worker_mode: bool = False
    gpu_model: str = ""  # torch.cuda.get_device_name on a torch worker
    vram_gb: int = 0  # its total memory in GiB
    accelerator: str = ""
    tpu_chip_count: int = 0
    hbm_gb_per_chip: float = 0.0
    ici_topology: str = ""
    max_context_length: int = 0
    # Whether this worker's engine serves /api/embed.
    embeddings: bool = True
    # "direct" | "relay": how this worker is reachable.
    reachability: str = "direct"
    relay_capable: bool = False
    # Graceful drain: no new generate requests, still a KV donor.
    draining: bool = False
    draining_reason: str = ""  # "drain" | "wedged" | ""
    shard_group: ShardGroup | None = None

    def touch(self) -> None:
        self.last_updated = time.time()

    @property
    def age_seconds(self) -> float:
        return time.time() - self.last_updated

    def to_json(self) -> bytes:
        d = asdict(self)
        if self.shard_group is None:
            d.pop("shard_group")
        return json.dumps(d, sort_keys=True).encode()

    @classmethod
    def from_json(cls, data: bytes | str) -> "Resource":
        try:
            d: dict[str, Any] = json.loads(data)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f"invalid resource JSON: {e}") from e
        if not isinstance(d, dict):
            raise ValueError("invalid resource JSON: not an object")
        sg = d.pop("shard_group", None)
        known = {f for f in cls.__dataclass_fields__ if f != "shard_group"}
        r = cls(**{k: v for k, v in d.items() if k in known})
        if sg:
            r.shard_group = ShardGroup(
                **{k: v for k, v in sg.items()
                   if k in ShardGroup.__dataclass_fields__})
        return r
