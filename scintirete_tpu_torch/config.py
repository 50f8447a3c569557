"""Engine knobs the port reads: the `[tpu]` section of the server config.

A copy of the fields of `TPUConfig` (`scintirete_tpu/config.py`) that the
port's engine reads; the port imports nothing of the JAX package. The TOML
loader and the other sections go with the server, which is not ported yet
(ROADMAP.md). The engine reads these fields by name, so the JAX package's
own `TPUConfig` may be passed as well.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TPUConfig:
    """Device engine knobs (extension over the reference's config)."""

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
