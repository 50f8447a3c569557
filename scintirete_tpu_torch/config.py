"""TOML configuration with the reference's section/key contract. Port of
`scintirete_tpu/config.py`: the same sections, keys, defaults and checks,
so one TOML file loads into equal configs in both packages.

Reference: internal/config/config.go:17-101 (schema), :104-161 (defaults),
:206-307 (validation), configs/scintirete.template.toml (template). The same
TOML files the reference accepts load here unchanged; the device engine's
knobs live under the `[tpu]` section, whose name the port keeps.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Any, Optional

from scintirete_tpu_torch.errors import ErrorCode, ScintireteError


@dataclasses.dataclass
class ServerConfig:
    grpc_host: str = "127.0.0.1"
    grpc_port: int = 9090
    http_host: str = "127.0.0.1"
    http_port: int = 8080
    passwords: list[str] = dataclasses.field(default_factory=list)
    # per-client request rate limit (token bucket); 0 disables — the
    # reference defines the RateLimiter capability but ships it unwired
    rate_limit_rps: float = 0.0
    rate_limit_burst: int = 0  # 0 -> 2x rps


@dataclasses.dataclass
class LogConfig:
    level: str = "info"
    format: str = "json"
    enable_audit_log: bool = False


@dataclasses.dataclass
class PersistenceConfig:
    data_dir: str = "./data"
    rdb_filename: str = "vector.rdb"
    aof_filename: str = "appendonly.aof"
    aof_sync_strategy: str = "everysec"  # always | everysec | no
    rdb_interval_minutes: int = 5
    aof_rewrite_size_mb: int = 5
    # true: corruption anywhere aborts startup with CORRUPTED_DATA.
    # false (reference policy): warn, preserve the corrupt file as
    # <name>.corrupt-<ts>, and recover everything salvageable.
    strict_recovery: bool = False


@dataclasses.dataclass
class EmbeddingModel:
    id: str = ""
    name: str = ""
    dimension: int = 0
    available: bool = True
    description: str = ""


@dataclasses.dataclass
class EmbeddingConfig:
    base_url: str = "https://api.openai.com/v1/embeddings"
    api_key: str = ""
    rpm_limit: int = 3500
    tpm_limit: int = 90000
    default_model: str = "text-embedding-3-small"
    models: list[EmbeddingModel] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ObservabilityConfig:
    metrics_enabled: bool = True
    metrics_path: str = "/metrics"
    metrics_port: int = 9100


@dataclasses.dataclass
class HNSWDefaults:
    m: int = 16
    ef_construction: int = 200
    ef_search: int = 50
    neighbor_heuristic: bool = False  # reference-parity default


@dataclasses.dataclass
class AlgorithmConfig:
    hnsw_defaults: HNSWDefaults = dataclasses.field(default_factory=HNSWDefaults)


@dataclasses.dataclass
class MonitoringConfig:
    enabled: bool = False
    interval: int = 30
    cpu_enabled: bool = True
    cpu_threshold: float = 0.8
    memory_enabled: bool = True
    memory_threshold: int = 1024
    disk_enabled: bool = False
    disk_threshold: int = 10240


@dataclasses.dataclass
class TPUConfig:
    """Device engine knobs (extension over the reference's config)."""

    # the torch device the server runs its engine on: "" = the card
    # ("cuda"), "cpu" = the plain torch versions of the kernels on the host
    platform: str = ""
    # dtype for the device-resident vector matrix: float32 | bfloat16
    device_dtype: str = "float32"
    # default index for new collections: "hnsw" (reference behavior) or
    # "flat" (exact scan: recall 1.0, cheap writes)
    default_index_type: str = "hnsw"
    # batch size used by the chunked bulk-insert builder
    build_chunk_size: int = 1024
    # max concurrent queries fused into one device search dispatch
    search_batch_size: int = 256
    # flat index: narrow (bf16 / int8) full-corpus first pass + exact f32
    # rerank; returned distances stay f32-exact
    flat_fast_scan: bool = True
    # collections smaller than this search on the host; 0 = always device
    device_search_min_size: int = 4096
    # number of devices to shard large collections over (1 = single card)
    shard_devices: int = 1
    # after recovery, search every restored collection once in the
    # background, so its mirror upload is not paid inside the first
    # client query
    warm_search_on_start: bool = True
    # parsed for the JAX package's files; the port has no append prewarm
    # (ROADMAP.md Queue 1, the prewarm item) and ignores it
    warm_append_on_start: bool = True


@dataclasses.dataclass
class Config:
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    log: LogConfig = dataclasses.field(default_factory=LogConfig)
    persistence: PersistenceConfig = dataclasses.field(default_factory=PersistenceConfig)
    embedding: EmbeddingConfig = dataclasses.field(default_factory=EmbeddingConfig)
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig
    )
    algorithm: AlgorithmConfig = dataclasses.field(default_factory=AlgorithmConfig)
    monitoring: MonitoringConfig = dataclasses.field(default_factory=MonitoringConfig)
    tpu: TPUConfig = dataclasses.field(default_factory=TPUConfig)

    # ----- validation (reference: config.go:206-307) -----

    def validate(self) -> None:
        def fail(msg: str) -> None:
            raise ScintireteError(ErrorCode.CONFIG, msg)

        try:
            self._validate(fail)
        except ScintireteError:
            raise
        except TypeError as exc:
            # wrong-typed TOML values (grpc_port = "9090") must surface
            # as the CONFIG error contract, not a raw comparison TypeError
            fail(f"wrong-typed config value: {exc}")

    def _validate(self, fail) -> None:
        for port_name, port in (
            ("server.grpc_port", self.server.grpc_port),
            ("server.http_port", self.server.http_port),
            ("observability.metrics_port", self.observability.metrics_port),
        ):
            if not (0 < port < 65536):
                fail(f"{port_name} out of range: {port}")
        if self.server.grpc_port == self.server.http_port:
            fail("server.grpc_port and server.http_port must differ")
        if self.log.level not in ("debug", "info", "warn", "error"):
            fail(f"invalid log.level: {self.log.level}")
        if self.log.format not in ("text", "json"):
            fail(f"invalid log.format: {self.log.format}")
        if self.persistence.aof_sync_strategy not in ("always", "everysec", "no"):
            fail(
                "invalid persistence.aof_sync_strategy: "
                f"{self.persistence.aof_sync_strategy}"
            )
        if self.persistence.rdb_interval_minutes <= 0:
            fail("persistence.rdb_interval_minutes must be > 0")
        if self.persistence.aof_rewrite_size_mb <= 0:
            fail("persistence.aof_rewrite_size_mb must be > 0")
        hd = self.algorithm.hnsw_defaults
        if hd.m <= 0 or hd.ef_construction <= 0 or hd.ef_search <= 0:
            fail("algorithm.hnsw_defaults values must be > 0")
        for model in self.embedding.models:
            if not model.id:
                fail("embedding model id must not be empty")
            if model.dimension <= 0 or model.dimension > 8192:
                fail(f"embedding model {model.id}: invalid dimension")
        if self.tpu.platform not in ("", "cuda", "cpu"):
            fail(f"invalid tpu.platform: {self.tpu.platform}")
        if self.tpu.device_dtype not in ("float32", "bfloat16"):
            fail(f"invalid tpu.device_dtype: {self.tpu.device_dtype}")
        if self.tpu.default_index_type not in ("hnsw", "flat"):
            fail(f"invalid tpu.default_index_type: {self.tpu.default_index_type}")
        if self.tpu.build_chunk_size <= 0:
            fail("tpu.build_chunk_size must be > 0")
        if self.tpu.search_batch_size <= 0:
            fail("tpu.search_batch_size must be > 0")
        if self.monitoring.interval <= 0:
            fail("monitoring.interval must be > 0")
        if not (0 < self.monitoring.cpu_threshold <= 1.0):
            fail("monitoring.cpu_threshold must be in (0, 1]")
        if self.monitoring.memory_threshold <= 0:
            fail("monitoring.memory_threshold must be > 0")
        if self.monitoring.disk_threshold <= 0:
            fail("monitoring.disk_threshold must be > 0")

    def resolve_paths(self, base_dir: str) -> None:
        """Make persistence paths absolute relative to `base_dir`
        (reference: config.go:310-320)."""
        if not os.path.isabs(self.persistence.data_dir):
            self.persistence.data_dir = os.path.abspath(
                os.path.join(base_dir, self.persistence.data_dir)
            )

    def default_hnsw_params(self):
        from scintirete_tpu_torch.types import HNSWParams

        hd = self.algorithm.hnsw_defaults
        return HNSWParams(
            m=hd.m,
            ef_construction=hd.ef_construction,
            ef_search=hd.ef_search,
            neighbor_heuristic=hd.neighbor_heuristic,
        )


def _populate(obj: Any, data: dict[str, Any]) -> Any:
    """Fill a (possibly nested) dataclass from a dict, ignoring unknown keys."""
    fields = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in data.items():
        if key not in fields:
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _populate(current, value)
        elif key == "models" and isinstance(value, list):
            obj.models = [_populate(EmbeddingModel(), m) for m in value]
        else:
            setattr(obj, key, value)
    return obj


def load_config(path: Optional[str] = None) -> Config:
    """Load a TOML config file; `path=None` returns pure defaults
    (reference: config.go:164-188)."""
    cfg = Config()
    if path is not None:
        try:
            with open(path, "rb") as fh:
                data = tomllib.load(fh)
        except FileNotFoundError as exc:
            raise ScintireteError(
                ErrorCode.CONFIG, f"config file not found: {path}", cause=exc
            )
        except tomllib.TOMLDecodeError as exc:
            raise ScintireteError(
                ErrorCode.CONFIG, f"invalid TOML in {path}: {exc}", cause=exc
            )
        _populate(cfg, data)
        cfg.resolve_paths(os.path.dirname(os.path.abspath(path)))
    cfg.validate()
    return cfg
