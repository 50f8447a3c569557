"""Durability: append-only command log (AOF) + point-in-time snapshots (RDB).

Port of `scintirete_tpu/persistence/`. The records are the same bytes as
the JAX package's (`serde`: msgpack with an ndarray extension); the Go
reference's FlatBuffers format (`fbcompat`) is imported on its own, by the
admin tool only.
"""

from scintirete_tpu_torch.persistence.aof import AOFLogger, SyncStrategy  # noqa: F401
from scintirete_tpu_torch.persistence.rdb import RDBManager, BackupManager  # noqa: F401
from scintirete_tpu_torch.persistence.manager import PersistenceManager  # noqa: F401
