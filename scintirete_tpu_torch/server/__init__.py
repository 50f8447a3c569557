"""API servers: the core service (16 RPCs and BatchSearch), gRPC transport,
HTTP/JSON gateway. Port of `scintirete_tpu/server/` onto the port's
engine."""

from scintirete_tpu_torch.server.auth import BasicAuthenticator  # noqa: F401
from scintirete_tpu_torch.server.service import ScintireteService  # noqa: F401
