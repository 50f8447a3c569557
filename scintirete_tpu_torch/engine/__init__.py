"""Engine layer: multi-database / multi-collection management."""

from scintirete_tpu_torch.engine.collection import Collection  # noqa: F401
from scintirete_tpu_torch.engine.database import Database, Engine  # noqa: F401
