"""The port's transports and tools: gRPC over a real socket, the HTTP
gateway (held against the JAX package's gateway: the same requests get the
same statuses and bodies), the metrics server, the CLI and the server
process's lifecycle (mirrors of `tests/test_transports.py`,
`tests/test_cli.py` and `tests/test_server_lifecycle.py` at small shapes).
Every server binds 127.0.0.1 on a free port; the services run on the CPU
(`device="cpu"`), the embedding endpoint is a local fake."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import grpc
import numpy as np
import pytest

from scintirete_tpu.server.http_server import HttpGateway as JaxGateway
from scintirete_tpu_torch.cli.main import CLI, split_command
from scintirete_tpu_torch.observability.metrics import (
    MetricsRegistry,
    MetricsServer,
)
from scintirete_tpu_torch.proto import scintirete_pb2 as pb
from scintirete_tpu_torch.server.grpc_server import GrpcClient, GrpcServer
from scintirete_tpu_torch.server.http_server import HttpGateway
from tests.test_api import FakeEmbeddingServer
from tests.test_torch_server import PASSWORD, assert_same, make_service

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["host", "cpu"])
def service(request, tmp_path):
    svc = make_service(request.param, tmp_path / "data")
    yield svc
    svc.stop()


@pytest.fixture
def client(service):
    server = GrpcServer(service, port=0)
    server.start()
    c = GrpcClient(f"127.0.0.1:{server.port}", timeout=10)
    yield c
    c.close()
    server.stop()


@pytest.fixture
def gateway(service):
    gw = HttpGateway(service, port=0)
    gw.start()
    yield f"http://127.0.0.1:{gw.port}"
    gw.stop()


def http(url, method="GET", body=None, token=PASSWORD):
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def auth():
    return pb.AuthInfo(password=PASSWORD)


def fill(c, rows, col="col", metric=pb.L2):
    c.CreateDatabase(pb.CreateDatabaseRequest(auth=auth(), name="db"))
    c.CreateCollection(pb.CreateCollectionRequest(
        auth=auth(), db_name="db", collection_name=col, metric_type=metric))
    req = pb.InsertVectorsRequest(auth=auth(), db_name="db", collection_name=col)
    for v in rows:
        req.vectors.append(pb.Vector(elements=v.tolist()))
    return c.InsertVectors(req)


class TestGrpc:
    def test_flow_and_batch_search(self, client):
        vecs = np.random.default_rng(0).standard_normal((32, 8)).astype(np.float32)
        assert fill(client, vecs).inserted_count == 32
        found = client.Search(pb.SearchRequest(
            auth=auth(), db_name="db", collection_name="col",
            query_vector=vecs[2].tolist(), top_k=2))
        assert found.results[0].id == 3
        for dtype in ("f32", "f16"):
            q = vecs[:5].astype(np.float16 if dtype == "f16" else np.float32)
            resp = client.BatchSearch(pb.BatchSearchRequest(
                auth=auth(), db_name="db", collection_name="col",
                queries_packed=q.tobytes(), num_queries=5, dim=8, top_k=3,
                dtype=dtype))
            ids = np.frombuffer(resp.ids_packed, np.uint64).reshape(5, 3)
            assert list(ids[:, 0]) == [1, 2, 3, 4, 5]
        assert [r.id for r in client.Search(pb.SearchRequest(
            auth=auth(), db_name="db", collection_name="col",
            query_vector=vecs[4].tolist(), top_k=3)).results] == list(
                np.frombuffer(resp.ids_packed, np.uint64).reshape(5, 3)[4])

    @pytest.mark.parametrize("call,code", [
        (lambda c: c.ListDatabases(pb.ListDatabasesRequest(
            auth=pb.AuthInfo(password="bad"))), grpc.StatusCode.UNAUTHENTICATED),
        (lambda c: c.DropDatabase(pb.DropDatabaseRequest(
            auth=auth(), name="missing")), grpc.StatusCode.NOT_FOUND),
        (lambda c: c.CreateDatabase(pb.CreateDatabaseRequest(
            auth=auth(), name="db")), grpc.StatusCode.ALREADY_EXISTS),
        (lambda c: c.BatchSearch(pb.BatchSearchRequest(
            auth=auth(), db_name="db", collection_name="col",
            queries_packed=b"\x00" * 10, num_queries=5, dim=8, top_k=3)),
         grpc.StatusCode.INVALID_ARGUMENT),
        (lambda c: c.Search(pb.SearchRequest(
            auth=auth(), db_name="db", collection_name="col",
            query_vector=[1.0] * 3, top_k=3)), grpc.StatusCode.INVALID_ARGUMENT),
    ])
    def test_error_codes(self, client, call, code):
        fill(client, np.ones((4, 8), np.float32))
        with pytest.raises(grpc.RpcError) as exc:
            call(client)
        assert exc.value.code() == code

    def test_save(self, client):
        client.CreateDatabase(pb.CreateDatabaseRequest(auth=auth(), name="db"))
        assert client.Save(pb.SaveRequest(auth=auth())).success


class TestHttp:
    def test_health_and_auth(self, gateway):
        status, body = http(f"{gateway}/api/v1/health", token=None)
        assert status == 200 and body["status"] == "healthy"
        assert http(f"{gateway}/api/v1/databases", token=None)[0] == 401
        assert http(f"{gateway}/api/v1/databases", token="wrong")[0] == 401

    def test_flow(self, gateway):
        vecs = np.random.default_rng(1).standard_normal((4, 4)).astype(np.float32)
        assert http(f"{gateway}/api/v1/databases", "POST", {"name": "db"})[1][
            "success"]
        assert http(f"{gateway}/api/v1/databases/db/collections", "POST",
                    {"collection_name": "col", "metric_type": "COSINE"})[0] == 200
        status, body = http(
            f"{gateway}/api/v1/databases/db/collections/col/vectors", "POST",
            {"vectors": [{"elements": v.tolist(), "metadata": {"i": i}}
                         for i, v in enumerate(vecs)]})
        assert status == 200 and body["inserted_count"] == 4
        status, body = http(
            f"{gateway}/api/v1/databases/db/collections/col/search", "POST",
            {"query_vector": vecs[1].tolist(), "top_k": 2})
        assert int(body["results"][0]["id"]) == 2
        assert body["results"][0]["metadata"]["i"] == 1
        status, body = http(
            f"{gateway}/api/v1/databases/db/collections/col/vectors", "DELETE",
            {"ids": ["2"]})
        assert status == 200 and body["deleted_count"] == 1

    def test_errors_json_and_cors(self, gateway):
        status, body = http(f"{gateway}/api/v1/databases/missing/collections/x")
        assert status == 404 and body["code"] == 3000
        assert http(f"{gateway}/api/v1/nope")[0] == 404
        req = urllib.request.Request(
            f"{gateway}/api/v1/databases", data=b"{not json", method="POST",
            headers={"Authorization": f"Bearer {PASSWORD}"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 400
        req = urllib.request.Request(f"{gateway}/api/v1/databases",
                                     method="OPTIONS")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 204
            assert resp.headers["Access-Control-Allow-Origin"] == "*"


# The same HTTP requests against the JAX package's gateway and the port's:
# (method, path, body, token). Paths name databases, collections and ids
# the earlier requests create.
HTTP_SCRIPT = [
    ("GET", "/api/v1/databases", None, None),
    ("GET", "/api/v1/databases", None, "wrong"),
    ("POST", "/api/v1/databases", {"name": "db"}, PASSWORD),
    ("POST", "/api/v1/databases", {"name": "db"}, PASSWORD),
    ("POST", "/api/v1/databases", {}, PASSWORD),
    ("POST", "/api/v1/databases/db/collections",
     {"collection_name": "c", "metric_type": "COSINE", "index_type": "flat"},
     PASSWORD),
    ("POST", "/api/v1/databases/db/collections",
     {"collection_name": "h", "metric_type": "L2",
      "hnsw_config": {"m": 8, "ef_construction": 40}}, PASSWORD),
    ("POST", "/api/v1/databases/db/collections",
     {"collection_name": "x", "metric_type": "HAMMING"}, PASSWORD),
    ("POST", "/api/v1/databases/db/collections", {"collection_name": "u"},
     PASSWORD),
    ("POST", "/api/v1/databases/db/collections/c/vectors",
     {"vectors": [{"elements": [float(i), 1.0, -0.5 * i, 2.0],
                   "metadata": {"i": i}} for i in range(6)]}, PASSWORD),
    ("POST", "/api/v1/databases/db/collections/c/vectors", {"vectors": []},
     PASSWORD),
    ("POST", "/api/v1/databases/db/collections/c/vectors",
     {"vectors": [{"elements": [1.0, 2.0]}]}, PASSWORD),
    ("POST", "/api/v1/databases/db/collections/c/search",
     {"query_vector": [2.0, 1.0, -1.0, 2.0], "top_k": 3}, PASSWORD),
    ("POST", "/api/v1/databases/db/collections/c/search",
     {"query_vector": [2.0, 1.0, -1.0, 2.0], "top_k": 2,
      "include_vector": True}, PASSWORD),
    ("POST", "/api/v1/databases/db/collections/c/search",
     {"query_vector": [2.0, 1.0, -1.0, 2.0], "top_k": 0}, PASSWORD),
    ("POST", "/api/v1/databases/db/collections/c/search", {"top_k": 3},
     PASSWORD),
    ("POST", "/api/v1/databases/db/collections/missing/search",
     {"query_vector": [1.0, 1.0, 1.0, 1.0], "top_k": 3}, PASSWORD),
    ("POST", "/api/v1/databases/db/collections/c/search",
     {"query_vector": [1.0, 1.0], "top_k": 3}, PASSWORD),
    ("DELETE", "/api/v1/databases/db/collections/c/vectors", {"ids": ["3", "99"]},
     PASSWORD),
    ("POST", "/api/v1/databases/db/collections/c/search",
     {"query_vector": [2.0, 1.0, -1.0, 2.0], "top_k": 3}, PASSWORD),
    ("GET", "/api/v1/databases/db/collections/c", None, PASSWORD),
    ("GET", "/api/v1/databases/db/collections", None, PASSWORD),
    ("GET", "/api/v1/databases/nodb/collections/c", None, PASSWORD),
    ("GET", "/api/v1/embed/models", None, PASSWORD),
    ("POST", "/api/v1/save", {}, PASSWORD),
    ("DELETE", "/api/v1/databases/db/collections/h", None, PASSWORD),
    ("DELETE", "/api/v1/databases/db/collections/h", None, PASSWORD),
    ("DELETE", "/api/v1/databases/nodb", None, PASSWORD),
    ("GET", "/api/v1/nope", None, PASSWORD),
    ("GET", "/api/v1/health", None, None),
]


def run_http_script(side, data_dir):
    svc = make_service(side, data_dir)
    gw = (JaxGateway if side.startswith("jax") else HttpGateway)(svc, port=0)
    gw.start()
    out = []
    try:
        base = f"http://127.0.0.1:{gw.port}"
        for method, path, body, token in HTTP_SCRIPT:
            status, payload = http(base + path, method, body, token)
            payload.pop("duration_seconds", None)  # Save's wall time
            payload.pop("uptime_seconds", None)  # health's
            out.append((status, payload))
    finally:
        gw.stop()
        svc.stop()
    return out


@pytest.fixture(scope="module")
def http_transcripts(tmp_path_factory):
    return {side: run_http_script(side, tmp_path_factory.mktemp(side) / "d")
            for side in ("jax", "host", "cpu", "jax_device")}


@pytest.mark.parametrize("side,ref", [("host", "jax"), ("cpu", "jax_device")])
@pytest.mark.parametrize("step", range(len(HTTP_SCRIPT)))
def test_http_matches_the_jax_gateway(http_transcripts, side, ref, step):
    """Each request gets the JAX gateway's HTTP status and JSON body (on
    the same path: host or device), floats within 1e-5."""
    got, want = http_transcripts[side][step], http_transcripts[ref][step]
    assert got[0] == want[0], HTTP_SCRIPT[step]
    assert_same(got[1], want[1], f"{HTTP_SCRIPT[step][:2]}")


def test_http_script_statuses(http_transcripts):
    statuses = [s for s, _ in http_transcripts["jax"]]
    assert statuses[:3] == [401, 401, 200] and 409 in statuses
    assert {400, 404} <= set(statuses) and statuses[-1] == 200


def test_metrics_server():
    registry = MetricsRegistry()
    registry.requests_total.inc(method="Search")
    server = MetricsServer(registry, port=0)
    server.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=5) as resp:
            text = resp.read().decode()
        assert 'scintirete_requests_total{method="Search"} 1' in text
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/health", timeout=5) as resp:
            assert json.loads(resp.read())["status"] == "ok"
    finally:
        server.stop()


# ----- the CLI: mirrors of tests/test_cli.py -----


@pytest.fixture
def cli(client):
    return CLI(client, PASSWORD)


class TestCLI:
    def test_ping_version_help(self, cli):
        assert cli.execute("ping").startswith("PONG")
        assert "scintirete-tpu-cli" in cli.execute("version")
        for cmd in ("database", "collection", "vector", "text", "save"):
            assert cmd in cli.execute("help")

    def test_workflow(self, cli):
        assert "created" in cli.execute("database create mydb")
        cli.execute("use mydb")
        assert "created" in cli.execute("collection create vecs L2 8 50")
        assert "m=8" in cli.execute("collection info vecs")
        out = cli.execute('vector insert vecs [0.1, 0.2, 0.3, 0.4] {"tag": "x"}')
        assert "inserted id=1" in out
        out = cli.execute("vector search vecs [0.1, 0.2, 0.3, 0.4] 1")
        assert "id=1" in out and '"tag": "x"' in out
        assert "deleted 1" in cli.execute("vector delete vecs 1")
        assert "(no results)" in cli.execute("vector search vecs [0.1, 0.2, 0.3, 0.4] 1")
        assert "saved" in cli.execute("save")
        assert "background save" in cli.execute("bgsave")
        assert "dropped" in cli.execute("collection drop vecs")

    def test_errors(self, cli):
        with pytest.raises(ValueError, match="no database selected"):
            cli.execute("collection list")
        with pytest.raises(ValueError, match="unknown command"):
            cli.execute("frobnicate")
        cli.execute("database create db")
        cli.execute("use db")
        with pytest.raises(ValueError, match="metric"):
            cli.execute("collection create c HAMMING")
        assert split_command('x [1, {"a": "]"}] y') == ["x", '[1, {"a": "]"}]', "y"]

    def test_text_commands(self, tmp_path):
        fake = FakeEmbeddingServer()
        svc = make_service("cpu", tmp_path / "data", fake.url)
        server = GrpcServer(svc, port=0)
        server.start()
        c = GrpcClient(f"127.0.0.1:{server.port}", timeout=10)
        try:
            cli = CLI(c, PASSWORD)
            assert "default: fake-model" in cli.execute("text models")
            cli.execute("database create db")
            cli.execute("use db")
            cli.execute("collection create docs COSINE")
            assert "inserted id=1" in cli.execute(
                "text insert docs 'hello world' '{\"lang\": \"en\"}'")
            out = cli.execute("text search docs 'hello world' 1")
            assert "id=1" in out and '"lang": "en"' in out
        finally:
            c.close()
            server.stop()
            svc.stop()
            fake.stop()


# ----- the server process: mirrors of tests/test_server_lifecycle.py -----


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_main_serves_stops_and_recovers(tmp_path):
    """`python -m scintirete_tpu_torch.cli.server_main -config <toml>` with
    `[tpu] platform = "cpu"` serves gRPC and HTTP, exits 0 on SIGTERM
    after its final fsync, recovers on restart, and answers the one-shot
    CLI."""
    grpc_port, http_port = free_port(), free_port()
    config = tmp_path / "server.toml"
    config.write_text(
        f'[server]\ngrpc_port = {grpc_port}\nhttp_port = {http_port}\n'
        f'passwords = ["{PASSWORD}"]\n[log]\nenable_audit_log = true\n'
        f'[persistence]\ndata_dir = "{tmp_path}/data"\n'
        'aof_sync_strategy = "always"\n'
        '[observability]\nmetrics_enabled = false\n'
        '[tpu]\nplatform = "cpu"\ndevice_search_min_size = 0\n'
    )

    def start(*extra):
        proc = subprocess.Popen(
            [sys.executable, "-m", "scintirete_tpu_torch.cli.server_main",
             "-config", str(config), *extra],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                http(f"http://127.0.0.1:{http_port}/api/v1/health", token=None)
                return proc
            except (urllib.error.URLError, ConnectionError, OSError):
                if proc.poll() is not None:
                    raise AssertionError(proc.stdout.read().decode(errors="replace"))
                time.sleep(0.2)
        proc.kill()
        raise AssertionError("server did not become healthy in 60 s")

    def stop(proc):
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0

    base = f"http://127.0.0.1:{http_port}/api/v1"
    proc = start("-trace", str(tmp_path / "trace"))
    try:
        http(f"{base}/databases", "POST", {"name": "db"})
        http(f"{base}/databases/db/collections", "POST",
             {"collection_name": "c", "metric_type": "L2"})
        status, body = http(f"{base}/databases/db/collections/c/vectors", "POST", {
            "vectors": [{"elements": [float(i), 1.0, 0.0, -1.0],
                         "metadata": {"i": i}} for i in range(8)]})
        assert body["inserted_count"] == 8
    finally:
        stop(proc)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0

    proc = start("-device", "cpu")  # AOF-only recovery
    try:
        status, body = http(f"{base}/databases/db/collections/c/search", "POST",
                            {"query_vector": [3.0, 1.0, 0.0, -1.0], "top_k": 1})
        assert int(body["results"][0]["id"]) == 4
        assert body["results"][0]["metadata"]["i"] == 3
        assert http(f"{base}/health", token=None)[1]["stats"]["vectors"] == 8
        out = subprocess.run(
            [sys.executable, "-m", "scintirete_tpu_torch.cli.main",
             "-p", str(grpc_port), "-a", PASSWORD, "-d", "db",
             "collection", "info", "c"],
            cwd=ROOT, capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert "vectors=8" in out.stdout
    finally:
        stop(proc)


def test_server_main_bad_config_is_one_line(tmp_path):
    path = tmp_path / "bad.toml"
    path.write_text('[tpu]\nplatform = "tpu"\n')
    from scintirete_tpu_torch.cli.server_main import main

    assert main(["-config", str(path)]) == 1


def test_monitor_main_prints_samples(capsys):
    from scintirete_tpu_torch.cli.monitor_main import main

    assert main(["-i", "0.01", "-n", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["rss_bytes"] > 0
