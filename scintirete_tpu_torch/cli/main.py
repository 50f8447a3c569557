"""Interactive CLI: scintirete-tpu-cli. A copy of `scintirete_tpu/cli/main.py`
over the port's gRPC client:

    python -m scintirete_tpu_torch.cli.main -h 127.0.0.1 -p 9090 -a <password> [command]

Capability parity with the reference CLI
(reference: cmd/scintirete-cli/ — readline REPL + one-shot mode over gRPC,
flags -h/-p/-a/-d, startup health check via ListDatabases, command registry
help/quit/ping/version/use/database/collection/vector/text/save/bgsave,
cli/commands.go:25-40).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import grpc

from scintirete_tpu_torch import __version__
from scintirete_tpu_torch.proto import scintirete_pb2 as pb
from scintirete_tpu_torch.server.grpc_server import GrpcClient
from scintirete_tpu_torch.server.service import dict_to_struct, struct_to_dict

HELP = """Commands:
  help                                     show this help
  quit | exit                              leave the shell
  ping                                     round-trip latency check
  version                                  client version
  use <db>                                 set the current database
  database list                            list databases
  database create <name>                   create a database
  database drop <name>                     drop a database
  collection list                          list collections in current db
  collection create <name> <metric> [m] [ef_construction] [hnsw|flat]
                                           create a collection (metric: L2|COSINE|IP;
                                           flat = exact scan index)
  collection drop <name>                   drop a collection
  collection info <name>                   collection statistics
  vector insert <collection> <json-array> [json-metadata]
                                           insert one vector
  vector search <collection> <json-array> <top_k>
                                           search by vector
  vector delete <collection> <id> [id...]  delete vectors by id
  text insert <collection> <text> [json-metadata]
                                           embed text and insert
  text search <collection> <text> <top_k>  embed text and search
  text models                              list embedding models
  save                                     synchronous snapshot
  bgsave                                   background snapshot
"""

METRICS = {"L2": pb.L2, "COSINE": pb.COSINE, "IP": pb.INNER_PRODUCT}


def split_command(line: str) -> list[str]:
    """Whitespace tokenizer that keeps JSON values as single tokens.

    shlex would shred `[0.1, 0.2]` into several tokens AND strip the
    double quotes `{"title": "x"}` needs, so users typing the quickstart
    examples verbatim would get JSON errors. Rules: balanced `[...]` /
    `{...}` runs are one token kept verbatim (double-quote aware inside);
    `'...'`/`"..."` are shell-style quoted strings (quotes stripped);
    everything else splits on whitespace."""
    tokens: list[str] = []
    i, n = 0, len(line)
    while i < n:
        while i < n and line[i].isspace():
            i += 1
        if i >= n:
            break
        c = line[i]
        if c in "[{":
            j, depth, in_str = i, 0, False
            while j < n:
                ch = line[j]
                if in_str:
                    if ch == "\\":
                        j += 1
                    elif ch == '"':
                        in_str = False
                elif ch == '"':
                    in_str = True
                elif ch in "[{":
                    depth += 1
                elif ch in "]}":
                    depth -= 1
                    if depth == 0:
                        j += 1
                        break
                j += 1
            tokens.append(line[i:j])
            i = j
        elif c in "'\"":
            quote, j, buf = c, i + 1, []
            while j < n and line[j] != quote:
                if line[j] == "\\" and quote == '"' and j + 1 < n:
                    j += 1
                buf.append(line[j])
                j += 1
            tokens.append("".join(buf))
            i = j + 1
        else:
            j = i
            while j < n and not line[j].isspace():
                j += 1
            tokens.append(line[i:j])
            i = j
    return tokens


class CLI:
    def __init__(self, client: GrpcClient, password: str, database: str = ""):
        self.client = client
        self.password = password
        self.db = database

    def auth(self) -> pb.AuthInfo:
        return pb.AuthInfo(password=self.password)

    def require_db(self) -> str:
        if not self.db:
            raise ValueError("no database selected; run: use <db>")
        return self.db

    # ----- command dispatch -----

    def execute(self, line: str) -> str:
        return self.execute_tokens(split_command(line))

    def execute_tokens(self, parts: list[str]) -> str:
        if not parts:
            return ""
        cmd, args = parts[0].lower(), parts[1:]
        if cmd == "help":
            return HELP
        if cmd == "version":
            return f"scintirete-tpu-cli {__version__}"
        if cmd == "ping":
            t0 = time.time()
            self.client.ListDatabases(pb.ListDatabasesRequest(auth=self.auth()))
            return f"PONG ({(time.time() - t0) * 1000:.1f} ms)"
        if cmd == "use":
            if len(args) != 1:
                raise ValueError("usage: use <db>")
            self.db = args[0]
            return f"using database {self.db}"
        if cmd == "database":
            return self._database(args)
        if cmd == "collection":
            return self._collection(args)
        if cmd == "vector":
            return self._vector(args)
        if cmd == "text":
            return self._text(args)
        if cmd == "save":
            resp = self.client.Save(pb.SaveRequest(auth=self.auth()))
            return (
                f"saved {resp.snapshot_size} bytes in "
                f"{resp.duration_seconds * 1000:.1f} ms"
            )
        if cmd == "bgsave":
            resp = self.client.BgSave(pb.BgSaveRequest(auth=self.auth()))
            return f"background save started (job {resp.job_id})"
        raise ValueError(f"unknown command: {cmd} (try 'help')")

    def _database(self, args: list[str]) -> str:
        if args[:1] == ["list"]:
            resp = self.client.ListDatabases(pb.ListDatabasesRequest(auth=self.auth()))
            return "\n".join(resp.names) or "(none)"
        if len(args) == 2 and args[0] == "create":
            self.client.CreateDatabase(
                pb.CreateDatabaseRequest(auth=self.auth(), name=args[1])
            )
            return f"database {args[1]} created"
        if len(args) == 2 and args[0] == "drop":
            self.client.DropDatabase(
                pb.DropDatabaseRequest(auth=self.auth(), name=args[1])
            )
            return f"database {args[1]} dropped"
        raise ValueError("usage: database list|create <name>|drop <name>")

    def _collection(self, args: list[str]) -> str:
        db = self.require_db()
        if args[:1] == ["list"]:
            resp = self.client.ListCollections(
                pb.ListCollectionsRequest(auth=self.auth(), db_name=db)
            )
            lines = [
                f"{c.name}  dim={c.dimension} vectors={c.vector_count} "
                f"metric={pb.DistanceMetric.Name(c.metric_type)}"
                for c in resp.collections
            ]
            return "\n".join(lines) or "(none)"
        if len(args) >= 3 and args[0] == "create":
            name, metric = args[1], args[2].upper()
            if metric not in METRICS:
                raise ValueError(f"metric must be one of {sorted(METRICS)}")
            req = pb.CreateCollectionRequest(
                auth=self.auth(),
                db_name=db,
                collection_name=name,
                metric_type=METRICS[metric],
            )
            if len(args) >= 4:
                req.hnsw_config.m = int(args[3])
            if len(args) >= 5:
                req.hnsw_config.ef_construction = int(args[4])
            if len(args) >= 6:
                req.index_type = args[5].lower()
            self.client.CreateCollection(req)
            return f"collection {name} created"
        if len(args) == 2 and args[0] == "drop":
            self.client.DropCollection(
                pb.DropCollectionRequest(
                    auth=self.auth(), db_name=db, collection_name=args[1]
                )
            )
            return f"collection {args[1]} dropped"
        if len(args) == 2 and args[0] == "info":
            info = self.client.GetCollectionInfo(
                pb.GetCollectionInfoRequest(
                    auth=self.auth(), db_name=db, collection_name=args[1]
                )
            )
            return (
                f"name={info.name} dim={info.dimension} "
                f"vectors={info.vector_count} deleted={info.deleted_count} "
                f"memory={info.memory_bytes}B "
                f"metric={pb.DistanceMetric.Name(info.metric_type)} "
                f"m={info.hnsw_config.m} ef_c={info.hnsw_config.ef_construction} "
                f"index={info.index_type or 'hnsw'}"
            )
        raise ValueError("usage: collection list|create|drop|info ...")

    def _vector(self, args: list[str]) -> str:
        db = self.require_db()
        if len(args) >= 3 and args[0] == "insert":
            col, elements = args[1], json.loads(args[2])
            vec = pb.Vector(elements=[float(x) for x in elements])
            if len(args) >= 4:
                meta = dict_to_struct(json.loads(args[3]))
                if meta:
                    vec.metadata.CopyFrom(meta)
            resp = self.client.InsertVectors(
                pb.InsertVectorsRequest(
                    auth=self.auth(), db_name=db, collection_name=col, vectors=[vec]
                )
            )
            return f"inserted id={resp.inserted_ids[0]}"
        if len(args) >= 4 and args[0] == "search":
            col, elements, top_k = args[1], json.loads(args[2]), int(args[3])
            resp = self.client.Search(
                pb.SearchRequest(
                    auth=self.auth(),
                    db_name=db,
                    collection_name=col,
                    query_vector=[float(x) for x in elements],
                    top_k=top_k,
                )
            )
            return self._format_results(resp)
        if len(args) >= 3 and args[0] == "delete":
            col = args[1]
            ids = [int(x) for x in args[2:]]
            resp = self.client.DeleteVectors(
                pb.DeleteVectorsRequest(
                    auth=self.auth(), db_name=db, collection_name=col, ids=ids
                )
            )
            return f"deleted {resp.deleted_count}"
        raise ValueError("usage: vector insert|search|delete ...")

    def _text(self, args: list[str]) -> str:
        if args[:1] == ["models"]:
            resp = self.client.ListEmbeddingModels(
                pb.ListEmbeddingModelsRequest(auth=self.auth())
            )
            lines = [
                f"{m.id}  dim={m.dimension} available={m.available}  {m.name}"
                for m in resp.models
            ]
            lines.append(f"default: {resp.default_model}")
            return "\n".join(lines)
        db = self.require_db()
        if len(args) >= 3 and args[0] == "insert":
            col, text = args[1], args[2]
            t = pb.TextWithMetadata(text=text)
            if len(args) >= 4:
                meta = dict_to_struct(json.loads(args[3]))
                if meta:
                    t.metadata.CopyFrom(meta)
            resp = self.client.EmbedAndInsert(
                pb.EmbedAndInsertRequest(
                    auth=self.auth(), db_name=db, collection_name=col, texts=[t]
                )
            )
            return f"inserted id={resp.inserted_ids[0]}"
        if len(args) >= 4 and args[0] == "search":
            col, text, top_k = args[1], args[2], int(args[3])
            resp = self.client.EmbedAndSearch(
                pb.EmbedAndSearchRequest(
                    auth=self.auth(),
                    db_name=db,
                    collection_name=col,
                    query_text=text,
                    top_k=top_k,
                )
            )
            return self._format_results(resp)
        raise ValueError("usage: text insert|search|models ...")

    @staticmethod
    def _format_results(resp: pb.SearchResponse) -> str:
        if not resp.results:
            return "(no results)"
        lines = []
        for i, r in enumerate(resp.results):
            meta = struct_to_dict(r.metadata)
            suffix = f"  {json.dumps(meta)}" if meta else ""
            lines.append(f"{i + 1}. id={r.id} distance={r.distance:.6f}{suffix}")
        return "\n".join(lines)


def main(argv=None) -> int:
    # add_help off so -h can mean host like the reference CLI's flag set
    # (cmd/scintirete-cli/main.go:20-25: -h/-p/-a/-d); --help still works
    parser = argparse.ArgumentParser(
        prog="scintirete-tpu-cli",
        description="Interactive client for scintirete-tpu (gRPC)",
        add_help=False,
    )
    parser.add_argument("--help", action="help",
                        help="show this help message and exit")
    parser.add_argument("-h", "-H", "--host", dest="host",
                        default="127.0.0.1")
    parser.add_argument("-p", "--port", type=int, default=9090)
    parser.add_argument("-a", "--password", default="")
    parser.add_argument("-d", "--database", default="")
    parser.add_argument(
        "command", nargs="*", help="one-shot command (omit for interactive shell)"
    )
    args = parser.parse_args(argv)

    client = GrpcClient(f"{args.host}:{args.port}")
    cli = CLI(client, args.password, args.database)

    # startup health check (reference: cmd/scintirete-cli/main.go:97-110)
    try:
        cli.client.ListDatabases(pb.ListDatabasesRequest(auth=cli.auth()))
    except grpc.RpcError as exc:
        print(f"cannot reach server at {args.host}:{args.port}: {exc.code().name}",
              file=sys.stderr)
        if exc.code() != grpc.StatusCode.UNAUTHENTICATED:
            return 1

    if args.command:
        try:
            # the shell already tokenized argv; re-joining through quoting
            # would mangle JSON literals
            print(cli.execute_tokens(list(args.command)))
            return 0
        except (ValueError, TypeError, json.JSONDecodeError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        except grpc.RpcError as exc:
            print(f"rpc error: {exc.code().name}: {exc.details()}", file=sys.stderr)
            return 1

    try:  # line editing + history in the REPL (reference uses chzyer/readline)
        import readline  # noqa: F401
    except ImportError:
        pass
    print(f"scintirete-tpu-cli {__version__} — connected to {args.host}:{args.port}")
    print("type 'help' for commands, 'quit' to exit")
    while True:
        try:
            prompt = f"scintirete[{cli.db or '-'}]> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        line = line.strip()
        if line.lower() in ("quit", "exit"):
            return 0
        if not line:
            continue
        try:
            out = cli.execute(line)
            if out:
                print(out)
        except (ValueError, TypeError, json.JSONDecodeError) as exc:
            print(f"error: {exc}")
        except grpc.RpcError as exc:
            print(f"rpc error: {exc.code().name}: {exc.details()}")


if __name__ == "__main__":
    sys.exit(main())
