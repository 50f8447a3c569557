"""Shared types for the engine.

A copy of `scintirete_tpu/types.py`: the port imports nothing of the JAX
package.

Capability parity with the reference's shared types layer
(reference: pkg/types/types.go:64-193) — re-designed as Python dataclasses.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Optional, Sequence


class DistanceMetric(enum.IntEnum):
    """Distance metrics supported by the engine.

    Values match the reference proto enum (reference:
    schemas/proto/scintirete/v1/scintirete.proto DistanceMetric) where
    0 is unspecified.
    """

    UNSPECIFIED = 0
    L2 = 1
    COSINE = 2
    INNER_PRODUCT = 3

    @classmethod
    def parse(cls, value: "DistanceMetric | int | str") -> "DistanceMetric":
        if isinstance(value, DistanceMetric):
            return value
        if isinstance(value, int):
            return cls(value)
        name = value.strip().upper().replace("-", "_")
        aliases = {
            "L2": cls.L2,
            "EUCLIDEAN": cls.L2,
            "COSINE": cls.COSINE,
            "IP": cls.INNER_PRODUCT,
            "INNER_PRODUCT": cls.INNER_PRODUCT,
            "DOT": cls.INNER_PRODUCT,
        }
        if name not in aliases:
            raise ValueError(f"unknown distance metric: {value!r}")
        return aliases[name]


# Default HNSW hyper-parameters (reference: pkg/types/types.go:104-112 and
# configs/scintirete.template.toml:95-99).
DEFAULT_M = 16
DEFAULT_EF_CONSTRUCTION = 200
DEFAULT_EF_SEARCH = 50
DEFAULT_MAX_LAYERS = 16


@dataclasses.dataclass(frozen=True)
class HNSWParams:
    """HNSW build/search parameters.

    Reference: pkg/types/types.go HNSWParams. `ml` (level decay) defaults to
    1/ln(2) so P(level >= L) = 2^-L (reference: hnsw.go:458-469).
    `seed` drives reproducible level assignment; None -> time-based
    (reference default is time.Now().UnixNano()).
    """

    m: int = DEFAULT_M
    ef_construction: int = DEFAULT_EF_CONSTRUCTION
    ef_search: int = DEFAULT_EF_SEARCH
    max_layers: int = DEFAULT_MAX_LAYERS
    seed: Optional[int] = None
    # Diversity-aware neighbor selection (Malkov Alg. 4: keep a candidate
    # only if it is closer to the query than to any already-kept neighbor,
    # then fill remaining slots from the pruned set). The reference uses
    # only the simple nearest-M rule (hnsw.go:560-583), which fragments
    # clustered data into unreachable islands; False preserves reference
    # behavior exactly, True trades a little build time for much better
    # recall on real datasets.
    neighbor_heuristic: bool = False
    # NN-descent refinement rounds over the bulk-built layer-0 adjacency
    # (each round: neighbors-of-neighbors candidates -> exact distances ->
    # re-select -> reverse-edge cap). The doubling-round kNN constructor
    # gives early rows an incomplete forward scan; refinement closes that
    # gap (recall ceiling, VERDICT r3 item 8). 0 = off (reference-faithful
    # build); 1 round costs ~10-15% build time. No reference equivalent
    # (sequential insertion has no bulk-quality knob).
    refine_rounds: int = 0

    def resolved_seed(self) -> int:
        if self.seed is not None:
            return int(self.seed)
        return time.time_ns()

    def validate(self) -> None:
        from scintirete_tpu_torch.errors import ScintireteError, ErrorCode

        if self.m <= 0:
            raise ScintireteError(ErrorCode.INVALID_PARAMETER, "hnsw m must be > 0")
        if self.ef_construction <= 0:
            raise ScintireteError(
                ErrorCode.INVALID_PARAMETER, "hnsw ef_construction must be > 0"
            )
        if self.ef_search <= 0:
            raise ScintireteError(
                ErrorCode.INVALID_PARAMETER, "hnsw ef_search must be > 0"
            )
        if self.max_layers <= 0:
            raise ScintireteError(
                ErrorCode.INVALID_PARAMETER, "hnsw max_layers must be > 0"
            )


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Per-query search parameters (reference: pkg/types/types.go SearchParams).

    `ef_search=None` means "use the index default" (reference: hnsw.go:300-303).
    `include_vector` controls whether result vectors are materialized
    (reference: scintirete.proto SearchRequest.include_vector, default false).
    """

    top_k: int = 10
    ef_search: Optional[int] = None
    include_vector: bool = False


@dataclasses.dataclass(frozen=True)
class CollectionConfig:
    """Collection creation config (reference: pkg/types/types.go CollectionConfig)."""

    name: str
    metric: DistanceMetric = DistanceMetric.COSINE
    hnsw: HNSWParams = dataclasses.field(default_factory=HNSWParams)
    # TPU extension: dtype used for the device-resident vector matrix.
    # "float32" preserves reference-exact distances; "bfloat16" doubles
    # MXU throughput and halves HBM traffic at a small recall cost.
    device_dtype: str = "float32"
    # TPU extension: which index backs the collection.
    #   "hnsw" — graph index, sublinear scaling + low single-query latency
    #            (reference behavior, the default);
    #   "flat" — exact MXU scan (index/flat.py) — recall 1.0, O(append)
    #            builds; the throughput winner up to HBM scale.
    index_type: str = "hnsw"

    def validate(self) -> None:
        from scintirete_tpu_torch.errors import ScintireteError, ErrorCode

        if not self.name:
            raise ScintireteError(
                ErrorCode.INVALID_PARAMETER, "collection name must not be empty"
            )
        if self.metric == DistanceMetric.UNSPECIFIED:
            raise ScintireteError(
                ErrorCode.INVALID_PARAMETER, "distance metric must be specified"
            )
        if self.device_dtype not in ("float32", "bfloat16"):
            raise ScintireteError(
                ErrorCode.INVALID_PARAMETER,
                f"unsupported device_dtype {self.device_dtype!r}",
            )
        if self.index_type not in ("hnsw", "flat"):
            raise ScintireteError(
                ErrorCode.INVALID_PARAMETER,
                f"unsupported index_type {self.index_type!r}",
            )
        self.hnsw.validate()


@dataclasses.dataclass
class Vector:
    """A stored vector: server-assigned uint64 id, elements, JSON-able metadata.

    Reference: pkg/types/types.go Vector. IDs are assigned by the collection's
    auto-increment counter at insert time (reference: collection.go:113-116).
    """

    id: int
    elements: Sequence[float]
    metadata: Optional[dict[str, Any]] = None


@dataclasses.dataclass
class SearchResult:
    """One search hit (reference: proto SearchResultItem)."""

    id: int
    distance: float
    metadata: Optional[dict[str, Any]] = None
    vector: Optional[list[float]] = None


@dataclasses.dataclass
class CollectionInfo:
    """Collection statistics (reference: pkg/types/types.go CollectionInfo)."""

    name: str
    dimension: int
    vector_count: int
    deleted_count: int
    memory_bytes: int
    metric: DistanceMetric
    hnsw: HNSWParams
    index_type: str = "hnsw"


@dataclasses.dataclass
class DatabaseInfo:
    name: str
    collection_count: int
    created_at: float
    last_access: float
