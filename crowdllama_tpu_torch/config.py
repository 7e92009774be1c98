"""Node and engine configuration.

Counterpart of ``crowdllama_tpu/config.py``: ``Intervals`` (every
background cadence, compressed in test mode) and the fields of
``Configuration`` that the port's engine and worker read, under the same
names, defaults and ``CROWDLLAMA_TPU_*`` environment variables, layered
defaults -> environment -> CLI flags.  ``add_flags`` registers the subset
of the JAX CLI's flags the port serves, with the same flag names; flags
whose values the serving plan (``engine/plan.py``) refuses stay refused
there.  The consumer's fields (the gateway's port, admission, budgets,
SLO objectives, the stall watchdog and the hedge, the KV-ship hint, the
flight recorder) and a worker's ``worker_metrics_port`` parse as the JAX
package's, and so do speculation's (``spec_decode``, ``spec_draft``,
``spec_draft_model``, ``spec_draft_path``, ``spec_draft_max``,
``gateway_spec_pipeline``), with the JAX package's checks; a
``spec_draft_path`` must be a checkpoint directory, native or HF.  The
autopilot's (``autotune`` and its interval and dial ceilings) parse and
are checked as the JAX package's.  The replicated gateway's fields
(``gateway_peers``,
``gossip_interval``, ``gossip_snapshot_path``, ``tenant_quota``) and the
worker's KV fetch threshold (``kv_ship_min_tokens``) parse and are served
as the JAX package's, and so do the shard settings (``shard_group``,
``shard_index``, ``shard_count``, ``shard_strategy``: the sharded
engine's group), and so do the multi-process fields
(``dist_coordinator``, ``dist_num_processes``, ``dist_process_id``:
one worker over several processes, ``parallel/multihost.py``).  The one
new flag is
``--device {cuda,cpu}`` (default ``cuda``): entry points run on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field, fields


def is_test_mode() -> bool:
    return os.environ.get("CROWDLLAMA_TPU_TEST_MODE", "") == "1"


@dataclass
class Intervals:
    """Every background cadence in one place, test-mode aware: metadata
    publish 5 s, advertise 1 s, local metadata refresh 30 s, discovery
    10 s, health check 20 s, stale 60 s, quarantine 600 s."""

    discovery: float = 10.0
    advertise: float = 1.0
    metadata_publish: float = 5.0
    metadata_refresh: float = 30.0
    health_check: float = 20.0
    stale_after: float = 60.0
    cleanup: float = 20.0
    quarantine: float = 600.0
    metadata_max_age: float = 3600.0
    metadata_timeout: float = 5.0
    stream_read_timeout: float = 5.0
    backoff_base: float = 10.0
    max_failed_attempts: int = 3
    dht_provider_check: float = 60.0
    dht_bucket_refresh: float = 600.0
    relay_reprobe: float = 60.0
    # Minimum age before the advertise/publish tickers re-provide their
    # DHT records (membership or own-contact changes re-provide after at
    # most reprovide / 20; the provider TTL is 30 min).
    reprovide: float = 120.0

    @classmethod
    def default(cls) -> "Intervals":
        if is_test_mode():
            return cls(
                discovery=2.0,
                advertise=0.5,
                metadata_publish=1.0,
                metadata_refresh=5.0,
                health_check=5.0,
                stale_after=30.0,
                cleanup=5.0,
                quarantine=30.0,
                backoff_base=0.5,
                dht_provider_check=2.0,
                dht_bucket_refresh=5.0,
                relay_reprobe=2.0,
                reprovide=10.0,
            )
        return cls()


def _norm_quantize(value: str) -> str:
    """Normalize quantize spellings; reject unknown modes loudly."""
    v = (value or "").strip().lower()
    if v in ("", "none", "off", "0", "false"):
        return ""
    if v in ("int8", "int4"):
        return v
    raise ValueError(
        f"unknown quantize mode {value!r} (want '', 'int8' or 'int4')")


def _flag(value: str) -> bool:
    return value in ("1", "true")


def _csv(value: str) -> list[str]:
    return [a.strip() for a in value.split(",") if a.strip()]


def _check_spec(cfg) -> None:
    """The JAX package's speculation checks, and a ``spec_draft_path``
    that must be a checkpoint directory (native or HF)."""
    if cfg.spec_decode:
        if cfg.kv_layout == "contiguous" and cfg.kv_dtype != "bf16":
            raise ValueError(
                "spec_decode on the contiguous layout requires the bf16 KV "
                "cache: use --kv-dtype bf16 or --kv-layout paged (paged "
                "spec verifies against int8 pools)")
        if cfg.spec_draft < 1:
            raise ValueError("spec_draft must be >= 1")
        if cfg.spec_draft_max < 0:
            raise ValueError("spec_draft_max must be >= 0")
        if cfg.spec_draft_max and cfg.spec_draft_max < cfg.spec_draft:
            raise ValueError(
                f"spec_draft_max ({cfg.spec_draft_max}) must be >= "
                f"spec_draft ({cfg.spec_draft}): it is the adaptive "
                "controller's growth ceiling")
    if cfg.spec_decode == "draft":
        if not cfg.spec_draft_model and not cfg.spec_draft_path:
            raise ValueError(
                "spec_decode=draft needs --spec-draft-model (registry "
                "name) or --spec-draft-path (a distill-draft checkpoint "
                "dir, which carries its own config)")
        if cfg.kv_layout != "paged":
            raise ValueError(
                "draft-model speculation runs on the paged layout only "
                "(the serving default); drop --kv-layout contiguous or "
                "use spec_decode=ngram")
    if cfg.spec_draft_path:
        from crowdllama_tpu_torch.engine.weights import require_checkpoint

        require_checkpoint(cfg.spec_draft_path, "spec_draft_path")


@dataclass
class Configuration:
    # ---- node
    verbose: bool = False
    key_path: str = ""
    bootstrap_peers: list[str] = field(default_factory=list)  # "host:port"
    listen_host: str = "0.0.0.0"
    listen_port: int = 0  # 0 = ephemeral
    gateway_port: int = 9001  # the consumer's HTTP gateway
    ipc_socket: str = ""
    engine_backend: str = "jax"  # the real engine ("jax" names it) | "fake"
    # NAT traversal (net/relay.py): "auto" relays a worker only when the
    # bootstrap node cannot dial it back (re-probed every
    # intervals.relay_reprobe), "always" relays every worker's inbound
    # streams, "off" dials direct only.
    relay_mode: str = "auto"
    drain_timeout: float = 30.0  # graceful-shutdown grace for in-flight reqs
    kv_ship_timeout: float = 5.0  # cap on serving one KvFetchRequest
    # Observability plane: span ring capacity, age-based span eviction
    # (0 = capacity only), trace_id exemplars on the latency histograms.
    trace_buffer: int = 64
    trace_ttl: float = 0.0
    metrics_exemplars: bool = False
    # Where the engine serves: "cuda" (the card; refused without one) or
    # "cpu" (asked for explicitly).
    device: str = "cuda"
    # A worker's /metrics + /debug/trace + POST /drain listener (0 = off).
    worker_metrics_port: int = 0

    # ---- consumer (the gateway)
    # Per-request wall-clock budget in seconds, charged across retries and
    # failovers (X-Request-Timeout may lower it).
    request_timeout: float = 600.0
    # Routed requests in flight before new ones get 503 + Retry-After
    # (0 = off), and the Retry-After hint in seconds.
    admission_max_inflight: int = 0
    retry_after_s: float = 1.0
    # KV-ship hints: on a prefix-affinity miss the gateway names the worker
    # that last held the prefix as the chosen worker's page donor.
    kv_ship: bool = False
    # Stitched traces of interesting requests the flight recorder keeps.
    flight_recorder: int = 32
    # SLO objectives in ms (0 = off): TTFT and the decode step.
    slo_ttft_ms: float = 0.0
    slo_decode_ms: float = 0.0
    # The per-stream progress watchdog (max token gap, ms) and the hedged
    # first token (ms of first-token silence before a second worker is
    # raced); 0 = off.
    stream_stall_ms: float = 0.0
    hedge_ttft_ms: float = 0.0
    # A worker skips a donor fetch when fewer prefix tokens than this are
    # missing locally (the round trip would cost more than it saves).
    kv_ship_min_tokens: int = 512
    # The replicated gateway: the other replicas' p2p addresses to gossip
    # with, seconds between rounds, the map's snapshot file, and the
    # per-tenant quotas ("name=requests_per_sec,..."; "" = the global shed
    # only).
    gateway_peers: list[str] = field(default_factory=list)
    gossip_interval: float = 2.0
    gossip_snapshot_path: str = ""
    tenant_quota: str = ""
    # Gateway-drafted speculative pipeline: "off" | "gateway" (draft at
    # the gateway from spec_draft_path, DraftChunk frames ahead of the
    # worker) | "worker" (pure ack credits).  Streamed requests only.
    gateway_spec_pipeline: str = "off"

    # ---- engine
    model: str = "tinyllama-1.1b"
    # empty = random-init weights; else a native or an HF checkpoint dir
    model_path: str = ""
    # Destination for swarm-pulled checkpoints (net/model_share.py).
    models_dir: str = "~/.crowdllama-tpu/models"
    # Whether remote peers may trigger this worker to download a model
    # (MODEL_PROTOCOL "pull" op, proxied by the gateway's /api/pull).
    # Serving manifests/files for models it already has is always on.
    allow_swarm_pull: bool = True
    max_batch_slots: int = 8
    max_context_length: int = 2048
    decode_chunk: int = 8  # decode steps per device dispatch
    # "paged": page pool + prefix cache (the default); "contiguous":
    # [L, B, Hkv, S, Dh] per slot, decode through kernel D.
    kv_layout: str = "paged"
    # "bf16" or "int8": int8 KV with per-(position, kv head) scales, on
    # both layouts (paged: kernels B and C read the int8 pages).
    kv_dtype: str = "bf16"
    quantize: str = ""  # "" (bf16) | "int8" | "int4" weight-only (ops/quant.py)
    # "" | "ngram" (prompt-lookup drafts) | "draft" (a small draft model
    # proposes; paged layout only): engine/spec.py.
    spec_decode: str = ""
    spec_draft: int = 4  # draft tokens per verify step
    spec_draft_model: str = ""  # draft model registry name (spec "draft")
    spec_draft_path: str = ""   # native draft checkpoint dir
    # > 0: the acceptance-adaptive draft length retunes draft_len within
    # [0, spec_draft_max] between dispatches (0 pauses speculation).
    spec_draft_max: int = 0
    # "" = one device (paged: tp over the visible CUDA devices the kv heads
    # divide, 1 on a one-card machine); "2" = tp=2 (paged only; the other
    # axes are not ported).  TorchEngine(devices=...) places the tp ranks.
    mesh_shape: str = ""
    kv_page_size: int = 128
    kv_pool_tokens: int = 0  # 0 = slots x context (no overcommit)
    kv_prefix_cache: bool = True
    # Unified ragged batch: long prompts prefill inside the decode dispatch
    # in chunks of (step_token_budget - max_batch_slots) tokens; 0 = auto
    # (prefill_chunk + max_batch_slots).  Off (or the contiguous layout):
    # long prompts admit through legacy chunked prefill.
    ragged_prefill: bool = True
    step_token_budget: int = 0
    # Kernel-looped decode megastep: K full decode steps per host dispatch
    # with on-device sampling and done-flags, each flight one CUDA graph
    # replay on the card.  0 = the per-step-chunk path.
    megastep_k: int = 0
    # Dispatch self-watchdog: a flight older than this multiple of its
    # dispatch-class flight-duration EWMA marks the engine wedged and
    # self-drains.  0 = off.
    wedge_multiplier: float = 0.0
    # The closed-loop autopilot (engine/autotune.py): coordinate descent
    # over megastep K, the draft cap, step_token_budget, the prefill chunk
    # and the pipeline depth.  Off by default.
    autotune: bool = False
    # Retire windows per measurement phase (one move per ~2x this).
    autotune_interval: int = 32
    # Dial ceilings of the coordinate grids.
    autotune_megastep_max: int = 16
    autotune_draft_max: int = 8
    autotune_budget_max: int = 4096
    autotune_prefill_max: int = 1024
    autotune_depth_max: int = 32
    warmup: bool = True  # run each serving path once at engine start
    admission_pending_max: int = 0  # 0 = no load-shedding threshold
    # Directory ``capture_profile`` writes its traces under; "" = off.
    profile_dir: str = ""

    # Multi-worker sharded serving (engine/sharded.py): a node with
    # shard_count > 1 serves one shard of an N-way split; shard_group names
    # the group (same string on every member; default
    # "<model>/<strategy><count>").  Index 0 is the group leader.
    # strategy "pp": member i serves layer slice i (pipeline stages).
    # strategy "ep": member i hosts experts e % count == i (MoE models);
    # the leader runs attention/router and dispatches expert batches.
    shard_group: str = ""
    shard_index: int = 0
    shard_count: int = 1
    shard_strategy: str = "pp"  # "pp" | "ep"

    # Multi-process single-worker serving (parallel/multihost.py): every
    # process of one logical worker sets dist_coordinator to process 0's
    # "host:port" and the mesh spans every process's devices.  Empty =
    # one process (the common case).
    dist_coordinator: str = ""
    dist_num_processes: int = 0  # 0 = take WORLD_SIZE from the environment
    dist_process_id: int = -1    # -1 = take RANK from the environment

    intervals: Intervals = field(default_factory=Intervals.default)

    def __post_init__(self) -> None:
        self.kv_layout = (self.kv_layout or "contiguous").strip().lower()
        if self.kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv layout {self.kv_layout!r} "
                             "(want 'contiguous' or 'paged')")
        self.kv_dtype = (self.kv_dtype or "bf16").strip().lower()
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv dtype {self.kv_dtype!r} "
                             "(want 'bf16' or 'int8')")

    # Field -> environment variable, as the JAX package names them.
    _ENV = {
        "key_path": "CROWDLLAMA_TPU_KEY_PATH",
        "bootstrap_peers": "CROWDLLAMA_TPU_BOOTSTRAP_PEERS",
        "listen_host": "CROWDLLAMA_TPU_LISTEN_HOST",
        "listen_port": "CROWDLLAMA_TPU_LISTEN_PORT",
        "ipc_socket": "CROWDLLAMA_TPU_SOCKET",
        "engine_backend": "CROWDLLAMA_TPU_ENGINE",
        "relay_mode": "CROWDLLAMA_TPU_RELAY_MODE",
        "drain_timeout": "CROWDLLAMA_TPU_DRAIN_TIMEOUT",
        "kv_ship_timeout": "CROWDLLAMA_TPU_KV_SHIP_TIMEOUT",
        "trace_buffer": "CROWDLLAMA_TPU_TRACE_BUFFER",
        "trace_ttl": "CROWDLLAMA_TPU_TRACE_TTL",
        "metrics_exemplars": "CROWDLLAMA_TPU_METRICS_EXEMPLARS",
        "model": "CROWDLLAMA_TPU_MODEL",
        "model_path": "CROWDLLAMA_TPU_MODEL_PATH",
        "models_dir": "CROWDLLAMA_TPU_MODELS_DIR",
        "allow_swarm_pull": "CROWDLLAMA_TPU_ALLOW_SWARM_PULL",
        "max_batch_slots": "CROWDLLAMA_TPU_MAX_BATCH_SLOTS",
        "max_context_length": "CROWDLLAMA_TPU_MAX_CONTEXT_LENGTH",
        "decode_chunk": "CROWDLLAMA_TPU_DECODE_CHUNK",
        "kv_layout": "CROWDLLAMA_TPU_KV_LAYOUT",
        "kv_dtype": "CROWDLLAMA_TPU_KV_DTYPE",
        "quantize": "CROWDLLAMA_TPU_QUANTIZE",
        "spec_decode": "CROWDLLAMA_TPU_SPEC_DECODE",
        "spec_draft": "CROWDLLAMA_TPU_SPEC_DRAFT",
        "spec_draft_model": "CROWDLLAMA_TPU_SPEC_DRAFT_MODEL",
        "spec_draft_max": "CROWDLLAMA_TPU_SPEC_DRAFT_MAX",
        "mesh_shape": "CROWDLLAMA_TPU_MESH",
        "kv_page_size": "CROWDLLAMA_TPU_KV_PAGE_SIZE",
        "kv_pool_tokens": "CROWDLLAMA_TPU_KV_POOL_TOKENS",
        "kv_prefix_cache": "CROWDLLAMA_TPU_KV_PREFIX_CACHE",
        "ragged_prefill": "CROWDLLAMA_TPU_RAGGED_PREFILL",
        "step_token_budget": "CROWDLLAMA_TPU_STEP_TOKEN_BUDGET",
        "megastep_k": "CROWDLLAMA_TPU_MEGASTEP_K",
        "wedge_multiplier": "CROWDLLAMA_TPU_WEDGE_MULTIPLIER",
        "autotune": "CROWDLLAMA_TPU_AUTOTUNE",
        "autotune_interval": "CROWDLLAMA_TPU_AUTOTUNE_INTERVAL",
        "autotune_megastep_max": "CROWDLLAMA_TPU_AUTOTUNE_MEGASTEP_MAX",
        "autotune_draft_max": "CROWDLLAMA_TPU_AUTOTUNE_DRAFT_MAX",
        "autotune_budget_max": "CROWDLLAMA_TPU_AUTOTUNE_BUDGET_MAX",
        "autotune_prefill_max": "CROWDLLAMA_TPU_AUTOTUNE_PREFILL_MAX",
        "autotune_depth_max": "CROWDLLAMA_TPU_AUTOTUNE_DEPTH_MAX",
        "warmup": "CROWDLLAMA_TPU_WARMUP",
        "admission_pending_max": "CROWDLLAMA_TPU_ADMISSION_PENDING_MAX",
        "profile_dir": "CROWDLLAMA_TPU_PROFILE_DIR",
        "shard_group": "CROWDLLAMA_TPU_SHARD_GROUP",
        "shard_index": "CROWDLLAMA_TPU_SHARD_INDEX",
        "shard_count": "CROWDLLAMA_TPU_SHARD_COUNT",
        "shard_strategy": "CROWDLLAMA_TPU_SHARD_STRATEGY",
        "dist_coordinator": "CROWDLLAMA_TPU_DIST_COORDINATOR",
        "dist_num_processes": "CROWDLLAMA_TPU_DIST_NUM_PROCESSES",
        "dist_process_id": "CROWDLLAMA_TPU_DIST_PROCESS_ID",
        "gateway_port": "CROWDLLAMA_TPU_GATEWAY_PORT",
        "worker_metrics_port": "CROWDLLAMA_TPU_WORKER_METRICS_PORT",
        "request_timeout": "CROWDLLAMA_TPU_REQUEST_TIMEOUT",
        "admission_max_inflight": "CROWDLLAMA_TPU_ADMISSION_MAX_INFLIGHT",
        "retry_after_s": "CROWDLLAMA_TPU_RETRY_AFTER",
        "kv_ship": "CROWDLLAMA_TPU_KV_SHIP",
        "kv_ship_min_tokens": "CROWDLLAMA_TPU_KV_SHIP_MIN_TOKENS",
        "flight_recorder": "CROWDLLAMA_TPU_FLIGHT_RECORDER",
        "slo_ttft_ms": "CROWDLLAMA_TPU_SLO_TTFT_MS",
        "slo_decode_ms": "CROWDLLAMA_TPU_SLO_DECODE_MS",
        "stream_stall_ms": "CROWDLLAMA_TPU_STREAM_STALL_MS",
        "hedge_ttft_ms": "CROWDLLAMA_TPU_HEDGE_TTFT_MS",
        "gateway_peers": "CROWDLLAMA_TPU_GATEWAY_PEERS",
        "gossip_interval": "CROWDLLAMA_TPU_GOSSIP_INTERVAL",
        "gossip_snapshot_path": "CROWDLLAMA_TPU_GOSSIP_SNAPSHOT",
        "tenant_quota": "CROWDLLAMA_TPU_TENANT_QUOTA",
        "gateway_spec_pipeline": "CROWDLLAMA_TPU_GATEWAY_SPEC_PIPELINE",
        "spec_draft_path": "CROWDLLAMA_TPU_SPEC_DRAFT_PATH",
    }

    @classmethod
    def from_environment(cls, **overrides) -> "Configuration":
        """Defaults <- environment <- explicit overrides (``None`` values
        are skipped), then the JAX package's checks."""
        cfg = cls()
        env = os.environ
        cfg.verbose = env.get("CROWDLLAMA_TPU_VERBOSE", "") in ("1", "true")
        types = {f.name: f.type for f in fields(cls)}
        for name, var in cls._ENV.items():
            raw = env.get(var)
            if not raw:
                continue
            kind = types[name]
            if kind == "bool":
                value = _flag(raw)
            elif kind == "list[str]":
                value = _csv(raw)
            elif kind == "int":
                value = int(raw)
            elif kind == "float":
                value = float(raw)
            else:
                value = raw
            setattr(cfg, name, value)
        # A set but empty CROWDLLAMA_TPU_ALLOW_SWARM_PULL disables pulls
        # (the JAX package reads the variable whenever it is set).
        if env.get(cls._ENV["allow_swarm_pull"]) == "":
            cfg.allow_swarm_pull = False
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)
        cfg.__post_init__()
        cfg.quantize = _norm_quantize(cfg.quantize)
        cfg.spec_decode = (cfg.spec_decode or "").strip().lower()
        if cfg.spec_decode not in ("", "ngram", "draft"):
            raise ValueError(f"unknown spec_decode {cfg.spec_decode!r} "
                             "(want '', 'ngram' or 'draft')")
        cfg.relay_mode = (cfg.relay_mode or "auto").strip().lower()
        if cfg.relay_mode not in ("auto", "always", "off"):
            raise ValueError(f"unknown relay_mode {cfg.relay_mode!r} "
                             "(want 'auto', 'always' or 'off')")
        cfg.device = (cfg.device or "cuda").strip().lower()
        if cfg.device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {cfg.device!r} "
                             "(want 'cuda' or 'cpu')")
        for name, low, strict in (
                ("kv_page_size", 0, True), ("kv_pool_tokens", 0, False),
                ("trace_buffer", 1, False), ("trace_ttl", 0, False),
                ("drain_timeout", 0, True), ("kv_ship_timeout", 0, True),
                ("kv_ship_min_tokens", 0, False),
                ("admission_pending_max", 0, False),
                ("wedge_multiplier", 0, False),
                ("worker_metrics_port", 0, False),
                ("request_timeout", 0, True),
                ("admission_max_inflight", 0, False),
                ("retry_after_s", 0, False),
                ("flight_recorder", 1, False),
                ("autotune_interval", 1, False),
                ("autotune_megastep_max", 0, False),
                ("autotune_draft_max", 1, False),
                ("autotune_budget_max", 1, False),
                ("autotune_prefill_max", 64, False),
                ("autotune_depth_max", 1, False),
                ("slo_ttft_ms", 0, False), ("slo_decode_ms", 0, False),
                ("stream_stall_ms", 0, False), ("hedge_ttft_ms", 0, False),
                ("gossip_interval", 0, True)):
            v = getattr(cfg, name)
            if v < low or (strict and v == low):
                raise ValueError(f"{name} must be {'>' if strict else '>='} "
                                 f"{low}, got {v}")
        cfg.gateway_spec_pipeline = (
            cfg.gateway_spec_pipeline or "off").strip().lower()
        if cfg.gateway_spec_pipeline not in ("off", "gateway", "worker"):
            raise ValueError(f"unknown gateway_spec_pipeline "
                             f"{cfg.gateway_spec_pipeline!r} "
                             "(want 'off', 'gateway' or 'worker')")
        _check_spec(cfg)
        return cfg

    @staticmethod
    def add_flags(parser: argparse.ArgumentParser) -> None:
        """Register the CLI flags the port serves (the JAX CLI's names)."""
        parser.add_argument("--verbose", action="store_true", default=None)
        parser.add_argument("--key-path", dest="key_path")
        parser.add_argument(
            "--bootstrap-peers", dest="bootstrap_peers",
            help="comma-separated host:port bootstrap addresses")
        parser.add_argument("--listen-port", dest="listen_port", type=int)
        parser.add_argument("--gateway-port", dest="gateway_port", type=int)
        parser.add_argument("--model", dest="model")
        parser.add_argument("--model-path", dest="model_path")
        parser.add_argument("--engine", dest="engine_backend")
        parser.add_argument("--mesh", dest="mesh_shape")
        parser.add_argument("--shard-group", dest="shard_group",
                            help="sharded-model group id (same on all members)")
        parser.add_argument("--shard-index", dest="shard_index", type=int,
                            help="this worker's pipeline stage (0 = leader)")
        parser.add_argument("--shard-count", dest="shard_count", type=int,
                            help="number of workers sharing the model")
        parser.add_argument("--shard-strategy", dest="shard_strategy",
                            choices=("pp", "ep"),
                            help="pp: layer slices; ep: MoE expert banks")
        parser.add_argument("--dist-coordinator", dest="dist_coordinator",
                            help="multi-process: process 0's host:port "
                                 "(parallel/multihost.py)")
        parser.add_argument("--dist-num-processes",
                            dest="dist_num_processes", type=int)
        parser.add_argument("--dist-process-id", dest="dist_process_id",
                            type=int)
        parser.add_argument("--quantize", dest="quantize",
                            choices=("", "int8", "int4"),
                            help="weight-only quantization for the engine")
        parser.add_argument("--kv-layout", dest="kv_layout",
                            choices=("contiguous", "paged"),
                            help="KV cache layout (paged: shared page pool)")
        parser.add_argument("--kv-page-size", dest="kv_page_size", type=int,
                            help="paged KV page size in tokens")
        parser.add_argument("--kv-pool-tokens", dest="kv_pool_tokens",
                            type=int,
                            help="paged pool size in tokens (0 = no "
                                 "overcommit)")
        parser.add_argument("--kv-dtype", dest="kv_dtype",
                            choices=("bf16", "int8"),
                            help="KV cache dtype (int8: quantized cache, "
                                 "contiguous or paged layout)")
        parser.add_argument("--relay-mode", dest="relay_mode",
                            choices=("auto", "always", "off"),
                            help="NAT relay through the bootstrap node")
        parser.add_argument("--spec-decode", dest="spec_decode",
                            choices=("", "ngram", "draft"),
                            help="speculative decoding: ngram prompt lookup "
                                 "or a small draft model")
        parser.add_argument("--spec-draft", dest="spec_draft", type=int,
                            help="draft tokens per speculative verify step")
        parser.add_argument("--spec-draft-model", dest="spec_draft_model",
                            help="draft model name (spec_decode=draft)")
        parser.add_argument("--spec-draft-max", dest="spec_draft_max",
                            type=int,
                            help="enable acceptance-adaptive draft length: "
                                 "retune within [0, N] between dispatches "
                                 "(0 = fixed --spec-draft)")
        parser.add_argument("--step-token-budget", dest="step_token_budget",
                            type=int,
                            help="unified ragged batch: per-step token "
                                 "budget (decode slots + one prefill "
                                 "chunk; 0 = auto)")
        parser.add_argument("--megastep-k", dest="megastep_k", type=int,
                            help="kernel-looped decode megastep: K full "
                                 "decode steps per host dispatch with "
                                 "on-device sampling (0 = legacy per-step "
                                 "path)")
        parser.add_argument("--autotune", dest="autotune",
                            action="store_const", const=True, default=None,
                            help="closed-loop performance autopilot: "
                                 "coordinate descent over megastep K, the "
                                 "spec draft cap, step_token_budget, the "
                                 "prefill chunk and the pipeline depth")
        parser.add_argument("--autotune-interval", dest="autotune_interval",
                            type=int,
                            help="retire windows per autotune measurement "
                                 "phase (one dial move per ~2x this)")
        parser.add_argument("--autotune-megastep-max",
                            dest="autotune_megastep_max", type=int,
                            help="autotune ceiling for megastep K")
        parser.add_argument("--autotune-draft-max",
                            dest="autotune_draft_max", type=int,
                            help="autotune ceiling for the adaptive spec "
                                 "draft-length cap")
        parser.add_argument("--autotune-budget-max",
                            dest="autotune_budget_max", type=int,
                            help="autotune ceiling for the ragged "
                                 "step_token_budget")
        parser.add_argument("--autotune-prefill-max",
                            dest="autotune_prefill_max", type=int,
                            help="autotune ceiling for the prefill chunk")
        parser.add_argument("--no-ragged-prefill", dest="ragged_prefill",
                            action="store_const", const=False, default=None,
                            help="disable unified ragged prefill: long "
                                 "prompts use legacy chunked prefill")
        parser.add_argument("--profile-dir", dest="profile_dir",
                            help="enable torch.profiler captures into "
                                 "this dir")
        parser.add_argument("--trace-buffer", dest="trace_buffer", type=int,
                            help="span ring-buffer capacity (default 64)")
        parser.add_argument("--trace-ttl", dest="trace_ttl", type=float,
                            help="evict trace-ring spans older than this "
                                 "many seconds (0 = capacity-only)")
        parser.add_argument("--metrics-exemplars", dest="metrics_exemplars",
                            action="store_const", const=True, default=None,
                            help="attach trace_id exemplars to latency "
                                 "histogram buckets")
        parser.add_argument("--admission-pending-max",
                            dest="admission_pending_max", type=int,
                            help="worker: scheduler pending depth that "
                                 "rejects new work as overloaded (0 = off)")
        parser.add_argument("--kv-ship-timeout", dest="kv_ship_timeout",
                            type=float,
                            help="seconds a KV fetch may take before it "
                                 "is refused")
        parser.add_argument("--drain-timeout", dest="drain_timeout",
                            type=float,
                            help="graceful-drain window in seconds")
        parser.add_argument("--wedge-multiplier", dest="wedge_multiplier",
                            type=float,
                            help="worker self-watchdog: declare the engine "
                                 "wedged when a dispatch flight exceeds this "
                                 "multiple of its class EWMA and self-drain "
                                 "(0 = off)")
        parser.add_argument("--device", dest="device",
                            choices=("cuda", "cpu"),
                            help="where the engine serves (default cuda; "
                                 "without a card the worker refuses to "
                                 "start unless cpu is asked for)")
        parser.add_argument("--worker-metrics-port",
                            dest="worker_metrics_port", type=int,
                            help="worker-side /metrics + /debug/trace "
                                 "listener port (0 = disabled)")
        parser.add_argument("--flight-recorder", dest="flight_recorder",
                            type=int,
                            help="stitched traces of interesting requests "
                                 "kept for GET /debug/flightrecorder "
                                 "(default 32)")
        parser.add_argument("--slo-ttft-ms", dest="slo_ttft_ms", type=float,
                            help="TTFT objective in ms for the SLO "
                                 "burn-rate plane (0 = disabled)")
        parser.add_argument("--slo-decode-ms", dest="slo_decode_ms",
                            type=float,
                            help="per decode-step objective in ms for the "
                                 "SLO burn-rate plane (0 = disabled)")
        parser.add_argument("--stream-stall-ms", dest="stream_stall_ms",
                            type=float,
                            help="gateway per-stream progress watchdog: max "
                                 "token inter-arrival gap in ms before the "
                                 "stream is failed over with the worker "
                                 "quarantined as wedged (0 = off)")
        parser.add_argument("--hedge-ttft-ms", dest="hedge_ttft_ms",
                            type=float,
                            help="race the second-best worker when the first "
                                 "token is slower than this many ms (or the "
                                 "live TTFT p95 once known); exactly one "
                                 "stream is delivered (0 = off)")
        parser.add_argument("--request-timeout", dest="request_timeout",
                            type=float,
                            help="per-request wall-clock budget in seconds, "
                                 "charged across retries/failovers "
                                 "(X-Request-Timeout may lower it)")
        parser.add_argument("--admission-max-inflight",
                            dest="admission_max_inflight", type=int,
                            help="gateway: max concurrent routed requests "
                                 "before shedding 503s (0 = off)")
        parser.add_argument("--retry-after", dest="retry_after_s",
                            type=float,
                            help="Retry-After seconds hinted on shed 503s")
        parser.add_argument("--kv-ship", dest="kv_ship",
                            action="store_const", const=True, default=None,
                            help="hint the worker that last held a shared "
                                 "prefix as the chosen worker's KV donor")
        parser.add_argument("--kv-ship-min-tokens", dest="kv_ship_min_tokens",
                            type=int,
                            help="skip the fetch when fewer prefix tokens "
                                 "than this are missing locally")
        parser.add_argument("--gateway-peers", dest="gateway_peers",
                            help="other gateway replicas' p2p addresses "
                                 "(host:port, comma-separated) to gossip "
                                 "routing state with")
        parser.add_argument("--tenant-quota", dest="tenant_quota",
                            help="per-tenant admission quotas, "
                                 "name=requests_per_sec comma-separated "
                                 "(X-Tenant header; unknown tenants "
                                 "charge 'default')")
        parser.add_argument("--gossip-interval", dest="gossip_interval",
                            type=float,
                            help="seconds between gossip rounds")
        parser.add_argument("--gossip-snapshot", dest="gossip_snapshot_path",
                            help="gossip map snapshot file, written on "
                                 "shutdown and read at start")
        parser.add_argument("--gateway-spec-pipeline",
                            dest="gateway_spec_pipeline",
                            choices=("off", "gateway", "worker"),
                            help="gateway-drafted speculative pipeline: "
                                 "draft at the gateway (--spec-draft-path) "
                                 "or pace on the worker's own drafts")
        parser.add_argument("--spec-draft-path", dest="spec_draft_path",
                            help="draft model checkpoint dir (a native "
                                 "checkpoint)")

    _FLAG_FIELDS = (
        "verbose", "key_path", "listen_port", "model", "model_path",
        "engine_backend", "mesh_shape", "shard_group", "shard_index",
        "shard_count", "shard_strategy", "quantize", "kv_layout",
        "kv_page_size", "kv_pool_tokens", "kv_dtype", "relay_mode",
        "spec_decode", "spec_draft", "spec_draft_model", "spec_draft_max",
        "step_token_budget", "ragged_prefill", "megastep_k",
        "wedge_multiplier", "autotune", "autotune_interval",
        "autotune_megastep_max", "autotune_draft_max", "autotune_budget_max",
        "autotune_prefill_max", "profile_dir",
        "trace_buffer", "trace_ttl", "metrics_exemplars",
        "admission_pending_max", "kv_ship_timeout", "drain_timeout",
        "device", "gateway_port", "worker_metrics_port", "flight_recorder",
        "slo_ttft_ms", "slo_decode_ms", "stream_stall_ms", "hedge_ttft_ms",
        "request_timeout", "admission_max_inflight", "retry_after_s",
        "kv_ship", "kv_ship_min_tokens", "tenant_quota", "gossip_interval",
        "gossip_snapshot_path", "gateway_spec_pipeline", "spec_draft_path",
        "dist_coordinator", "dist_num_processes", "dist_process_id")

    @classmethod
    def from_flags(cls, args: argparse.Namespace) -> "Configuration":
        overrides = {k: getattr(args, k, None) for k in cls._FLAG_FIELDS}
        for name in ("bootstrap_peers", "gateway_peers"):
            v = getattr(args, name, None)
            if isinstance(v, str):
                overrides[name] = _csv(v)
        return cls.from_environment(**overrides)
