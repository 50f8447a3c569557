"""HTTP/JSON gateway.

A copy of `scintirete_tpu/server/http_server.py` on the port's own modules.

Mirrors the reference's REST surface (reference:
internal/server/http/routes.go:10-38) and delegates every call to the core
service IN-PROCESS, exactly like the reference gateway calls gRPC handler
methods directly (reference: http/server.go:21-47, handlers_vector.go:34).

- routes live under /api/v1; GET /api/v1/health is the only unauthenticated
  endpoint,
- auth is `Authorization: Bearer <token>` -> AuthInfo{password}
  (reference: http/middleware.go:21-61),
- bodies are protojson: proto field names, enums accepted as numbers or
  names, defaults emitted (reference: http/server.go:28-38),
- permissive CORS + OPTIONS preflight (reference: middleware.go:72-85),
- ScintireteError -> HTTP status mapping mirrors the gRPC code mapping
  (reference: http/helpers.go).
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from google.protobuf import json_format

from scintirete_tpu_torch.errors import ErrorCode, ScintireteError
from scintirete_tpu_torch.server.service import RPC_TYPES, ScintireteService

_HTTP_STATUS = {
    ErrorCode.DATABASE_NOT_FOUND: 404,
    ErrorCode.COLLECTION_NOT_FOUND: 404,
    ErrorCode.VECTOR_NOT_FOUND: 404,
    ErrorCode.DATABASE_ALREADY_EXISTS: 409,
    ErrorCode.COLLECTION_ALREADY_EXISTS: 409,
    ErrorCode.INVALID_PARAMETER: 400,
    ErrorCode.DIMENSION_MISMATCH: 400,
    ErrorCode.INVALID_VECTOR_ID: 400,
    ErrorCode.UNAUTHORIZED: 401,
    ErrorCode.FORBIDDEN: 403,
    ErrorCode.RATE_LIMITED: 429,
    ErrorCode.EMBEDDING_QUOTA_EXCEEDED: 429,
}

# (http_method, path_regex, rpc_name, url-param -> request-field)
_ROUTES = [
    ("POST", r"^/api/v1/databases$", "CreateDatabase", {}),
    ("DELETE", r"^/api/v1/databases/(?P<name>[^/]+)$", "DropDatabase", {}),
    ("GET", r"^/api/v1/databases$", "ListDatabases", {}),
    (
        "POST",
        r"^/api/v1/databases/(?P<db_name>[^/]+)/collections$",
        "CreateCollection",
        {},
    ),
    (
        "DELETE",
        r"^/api/v1/databases/(?P<db_name>[^/]+)/collections/(?P<collection_name>[^/]+)$",
        "DropCollection",
        {},
    ),
    (
        "GET",
        r"^/api/v1/databases/(?P<db_name>[^/]+)/collections/(?P<collection_name>[^/]+)$",
        "GetCollectionInfo",
        {},
    ),
    (
        "GET",
        r"^/api/v1/databases/(?P<db_name>[^/]+)/collections$",
        "ListCollections",
        {},
    ),
    (
        "POST",
        r"^/api/v1/databases/(?P<db_name>[^/]+)/collections/(?P<collection_name>[^/]+)/vectors$",
        "InsertVectors",
        {},
    ),
    (
        "DELETE",
        r"^/api/v1/databases/(?P<db_name>[^/]+)/collections/(?P<collection_name>[^/]+)/vectors$",
        "DeleteVectors",
        {},
    ),
    (
        "POST",
        r"^/api/v1/databases/(?P<db_name>[^/]+)/collections/(?P<collection_name>[^/]+)/search$",
        "Search",
        {},
    ),
    (
        "POST",
        r"^/api/v1/databases/(?P<db_name>[^/]+)/collections/(?P<collection_name>[^/]+)/embed$",
        "EmbedAndInsert",
        {},
    ),
    (
        "POST",
        r"^/api/v1/databases/(?P<db_name>[^/]+)/collections/(?P<collection_name>[^/]+)/embed/search$",
        "EmbedAndSearch",
        {},
    ),
    ("POST", r"^/api/v1/embed$", "EmbedText", {}),
    ("GET", r"^/api/v1/embed/models$", "ListEmbeddingModels", {}),
    ("POST", r"^/api/v1/save$", "Save", {}),
    ("POST", r"^/api/v1/bgsave$", "BgSave", {}),
]


class HttpGateway:
    def __init__(
        self, service: ScintireteService, host: str = "127.0.0.1", port: int = 8080
    ):
        self.service = service
        service_ref = service
        start_time = time.time()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            # ----- plumbing -----

            def _send(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self._cors()
                self.end_headers()
                self.wfile.write(body)

            def _cors(self) -> None:
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header(
                    "Access-Control-Allow-Methods", "GET, POST, DELETE, OPTIONS"
                )
                self.send_header(
                    "Access-Control-Allow-Headers", "Authorization, Content-Type"
                )

            def _bearer(self) -> Optional[str]:
                header = self.headers.get("Authorization", "")
                parts = header.split(" ", 1)
                if len(parts) != 2 or parts[0].lower() != "bearer" or not parts[1]:
                    return None
                return parts[1]

            def _body_json(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                if length == 0:
                    return {}
                raw = self.rfile.read(length)
                try:
                    data = json.loads(raw.decode())
                except json.JSONDecodeError as exc:
                    raise ScintireteError(
                        ErrorCode.INVALID_PARAMETER, f"invalid JSON body: {exc}"
                    )
                if not isinstance(data, dict):
                    raise ScintireteError(
                        ErrorCode.INVALID_PARAMETER, "JSON body must be an object"
                    )
                return data

            # ----- dispatch -----

            def _handle(self, http_method: str) -> None:
                try:
                    self._route(http_method)
                except ScintireteError as exc:
                    self._send(
                        _HTTP_STATUS.get(exc.code, 500),
                        {"success": False, "error": exc.message, "code": int(exc.code)},
                    )
                except json_format.ParseError as exc:
                    self._send(400, {"success": False, "error": str(exc)})
                except Exception as exc:  # pragma: no cover - defensive
                    service_ref.logger.error("http handler error", error=repr(exc))
                    self._send(500, {"success": False, "error": str(exc)})

            def _route(self, http_method: str) -> None:
                path = self.path.split("?", 1)[0]
                if http_method == "GET" and path == "/api/v1/health":
                    self._send(
                        200,
                        {
                            "status": "healthy",
                            "uptime_seconds": round(time.time() - start_time, 3),
                            "stats": service_ref.engine.stats(),
                        },
                    )
                    return
                for method, pattern, rpc, _ in _ROUTES:
                    if method != http_method:
                        continue
                    match = re.match(pattern, path)
                    if not match:
                        continue
                    token = self._bearer()
                    if token is None:
                        self._send(
                            401,
                            {"success": False, "error": "Authorization header required"},
                        )
                        return
                    body = self._body_json()
                    body.update(match.groupdict())
                    body.pop("auth", None)  # auth comes from the header only
                    req_cls, _ = RPC_TYPES[rpc]
                    request = req_cls()
                    json_format.ParseDict(body, request, ignore_unknown_fields=True)
                    request.auth.password = token
                    response = getattr(service_ref, rpc)(request)
                    self._send(
                        200,
                        json_format.MessageToDict(
                            response,
                            preserving_proto_field_name=True,
                            always_print_fields_with_no_presence=True,
                        ),
                    )
                    return
                self._send(404, {"success": False, "error": "not found"})

            def do_GET(self):  # noqa: N802
                self._handle("GET")

            def do_POST(self):  # noqa: N802
                self._handle("POST")

            def do_DELETE(self):  # noqa: N802
                self._handle("DELETE")

            def do_OPTIONS(self):  # noqa: N802
                self.send_response(204)
                self._cors()
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-gateway", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2.0)
