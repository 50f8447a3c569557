"""Sharding: indexes split over a list of torch devices."""

from scintirete_tpu_torch.parallel.sharded import (  # noqa: F401
    CPU_SHARD_DEVICES,
    ShardedFlatIndex,
    ShardedHNSWIndex,
    make_default_mesh,
)
