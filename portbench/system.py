"""The system under test, set up in this process: the port's `Engine`
holding the base as a recovered snapshot would (no AOF records for it),
`ScintireteService` with password auth and the configuration's AOF
policy, and a `GrpcServer` on 127.0.0.1 at a free port.

The configuration's `deployment` section holds the server's settings
section by section, as the TOML template names them; `collection` names
the metric and the index. torch and the port are imported when a System
is made, not when this module is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

DB = "bench"
PASSWORD = "portbench-bench-password"


def _populate(obj: Any, values: dict[str, Any]) -> None:
    for key, value in values.items():
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current):
            _populate(current, value)
        else:
            setattr(obj, key, value)


class System:
    def __init__(self, config: dict, seed: int, device: str, data_dir: str):
        from scintirete_tpu_torch.config import Config
        from scintirete_tpu_torch.engine import Engine

        self.config = config
        self.device = device
        self.cfg = Config()
        _populate(self.cfg, config["deployment"])
        self.cfg.server.passwords = [PASSWORD]
        self.cfg.persistence.data_dir = data_dir
        self.cfg.validate()
        self.seed = seed
        self.name = config["collection"]["name"]
        self.engine = Engine(use_device=True, tpu_config=self.cfg.tpu,
                             device=device)
        self.db = self.engine.create_database(DB)
        self.service = None
        self.server = None
        self.base_ids: Optional[np.ndarray] = None

    def load(self, base: np.ndarray, control: Optional[str] = None) -> None:
        """Insert the base in process (an HNSW base pays the bulk build
        here). With `control`, the reference in lower precision takes the
        collection's place instead."""
        from scintirete_tpu_torch.types import CollectionConfig, DistanceMetric

        col = self.config["collection"]
        if control is not None:
            from portbench.reference.control import ControlCollection

            ctl = ControlCollection(self.name, base.shape[1], col["metric"],
                                    self.device, control)
            self.db._collections[self.name] = ctl
            self.base_ids = np.asarray(ctl.insert([(r, None) for r in base]),
                                       np.uint64)
            return
        hnsw = dataclasses.replace(self.cfg.default_hnsw_params(),
                                   seed=self.seed % (1 << 31))
        c = self.db.create_collection(CollectionConfig(
            name=self.name,
            metric=DistanceMetric[col["metric"].upper()],
            hnsw=hnsw,
            device_dtype=self.cfg.tpu.device_dtype,
            index_type=col["index_type"],
        ))
        self.base_ids = np.asarray(c.insert([(r, None) for r in base]),
                                   np.uint64)

    def collection(self):
        return self.db.get_collection(self.name)

    def serve(self, before_bind: Optional[Callable[[Any], None]] = None) -> int:
        """Start the service (recovery of an empty directory, its own
        warm-up of the loaded collection, waited for) and the gRPC server;
        returns its port. `before_bind(service)` runs before the server
        binds the service's methods (the traced run wraps them there)."""
        from scintirete_tpu_torch.server.grpc_server import GrpcServer
        from scintirete_tpu_torch.server.service import ScintireteService

        self.service = ScintireteService(self.cfg, engine=self.engine,
                                         device=self.device)
        if before_bind is not None:
            before_bind(self.service)
        self.service.start()
        if self.service._warm_thread is not None:
            self.service._warm_thread.join()
        self.server = GrpcServer(self.service, host="127.0.0.1", port=0)
        self.server.start()
        return self.server.port

    def stop(self) -> None:
        """Stop the server and the service, and drop the engine's state."""
        if self.server is not None:
            self.server.stop(grace=1.0)
        if self.service is not None:
            self.service.stop()
        self.engine.close()
        self.server = self.service = self.db = None
