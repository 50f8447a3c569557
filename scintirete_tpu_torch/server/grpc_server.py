"""gRPC transport for the core service.

A copy of `scintirete_tpu/server/grpc_server.py` on the port's own modules.

Wire-compatible with the reference server (service name
`scintirete.v1.ScintireteService`, 16 unary RPCs). Handlers are registered
through grpc's generic-handler API with the generated message classes doing
ser/de. Error mapping follows the reference (reference: grpc/helpers.go:17-38
— not-found -> NOT_FOUND, exists -> ALREADY_EXISTS, bad params ->
INVALID_ARGUMENT, auth -> UNAUTHENTICATED/PERMISSION_DENIED, rate limit ->
RESOURCE_EXHAUSTED, else INTERNAL).
"""

from __future__ import annotations

from concurrent import futures
import grpc

from scintirete_tpu_torch.errors import ErrorCode, ScintireteError
from scintirete_tpu_torch.proto import scintirete_pb2 as pb
from scintirete_tpu_torch.server.service import RPC_METHODS, RPC_TYPES, ScintireteService

SERVICE_NAME = "scintirete.v1.ScintireteService"

_CODE_MAP = {
    ErrorCode.DATABASE_NOT_FOUND: grpc.StatusCode.NOT_FOUND,
    ErrorCode.COLLECTION_NOT_FOUND: grpc.StatusCode.NOT_FOUND,
    ErrorCode.VECTOR_NOT_FOUND: grpc.StatusCode.NOT_FOUND,
    ErrorCode.DATABASE_ALREADY_EXISTS: grpc.StatusCode.ALREADY_EXISTS,
    ErrorCode.COLLECTION_ALREADY_EXISTS: grpc.StatusCode.ALREADY_EXISTS,
    ErrorCode.INVALID_PARAMETER: grpc.StatusCode.INVALID_ARGUMENT,
    ErrorCode.DIMENSION_MISMATCH: grpc.StatusCode.INVALID_ARGUMENT,
    ErrorCode.INVALID_VECTOR_ID: grpc.StatusCode.INVALID_ARGUMENT,
    ErrorCode.UNAUTHORIZED: grpc.StatusCode.UNAUTHENTICATED,
    ErrorCode.FORBIDDEN: grpc.StatusCode.PERMISSION_DENIED,
    ErrorCode.RATE_LIMITED: grpc.StatusCode.RESOURCE_EXHAUSTED,
    ErrorCode.EMBEDDING_QUOTA_EXCEEDED: grpc.StatusCode.RESOURCE_EXHAUSTED,
}


def grpc_status_for(exc: ScintireteError) -> grpc.StatusCode:
    return _CODE_MAP.get(exc.code, grpc.StatusCode.INTERNAL)


class GrpcServer:
    def __init__(
        self,
        service: ScintireteService,
        host: str = "127.0.0.1",
        port: int = 9090,
        max_workers: int = 64,
        # 64 (not the old 16): legacy b=1 Search RPCs park their worker
        # thread in SearchBatcher.submit until the coalesced device
        # dispatch returns — the worker count caps how many concurrent
        # single-query clients can fuse into one launch, and parked
        # threads are cheap (they hold no GIL while waiting)
    ):
        self.service = service
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[
                ("grpc.max_receive_message_length", 256 * 1024 * 1024),
                ("grpc.max_send_message_length", 256 * 1024 * 1024),
            ],
        )
        handlers = {m: self._wrap(m) for m in RPC_METHODS}
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
        )
        self.port = self._server.add_insecure_port(f"{host}:{port}")

    def _wrap(self, method: str) -> grpc.RpcMethodHandler:
        req_cls, _ = RPC_TYPES[method]
        fn = getattr(self.service, method)

        def handler(request, context):
            try:
                return fn(request)
            except ScintireteError as exc:
                context.abort(grpc_status_for(exc), exc.message)
            except Exception as exc:  # pragma: no cover - defensive
                self.service.logger.error(
                    "unhandled RPC error", method=method, error=repr(exc)
                )
                context.abort(grpc.StatusCode.INTERNAL, str(exc))

        return grpc.unary_unary_rpc_method_handler(
            handler,
            request_deserializer=req_cls.FromString,
            response_serializer=lambda msg: msg.SerializeToString(),
        )

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float = 2.0) -> None:
        self._server.stop(grace).wait(timeout=grace + 1)


class GrpcClient:
    """Thin typed client over the 16 RPCs (used by the CLI and tests)."""

    def __init__(self, address: str, timeout: float = 30.0):
        self.channel = grpc.insecure_channel(
            address,
            options=[
                ("grpc.max_receive_message_length", 256 * 1024 * 1024),
                ("grpc.max_send_message_length", 256 * 1024 * 1024),
            ],
        )
        self.timeout = timeout
        self._calls = {}
        for method in RPC_METHODS:
            req_cls, resp_cls = RPC_TYPES[method]
            self._calls[method] = self.channel.unary_unary(
                f"/{SERVICE_NAME}/{method}",
                request_serializer=lambda msg: msg.SerializeToString(),
                response_deserializer=resp_cls.FromString,
            )

    def call(self, method: str, request) -> "pb.Message":
        return self._calls[method](request, timeout=self.timeout)

    def __getattr__(self, name: str):
        if name in RPC_METHODS:
            return lambda request: self.call(name, request)
        raise AttributeError(name)

    def close(self) -> None:
        self.channel.close()
