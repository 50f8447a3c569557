"""The port's offline data-directory administration: a copy of
`scintirete_tpu/cli/admin_main.py` on the port's persistence and engine.

Exposes the BackupManager (reference: internal/persistence/rdb/rdb.go:890-979
— timestamped snapshot copies) plus an AOF/RDB inspection command. These
operate directly on the server's data directory and are meant to run on the
server host (the wire protocol has no backup RPCs in the reference either).

    python -m scintirete_tpu_torch.cli.admin_main -data-dir ./data backup create
    python -m scintirete_tpu_torch.cli.admin_main -data-dir ./data backup list
    python -m scintirete_tpu_torch.cli.admin_main -data-dir ./data backup restore <path>
    python -m scintirete_tpu_torch.cli.admin_main -data-dir ./data inspect

import-reference and export-reference rebuild the collections in an engine
on `-device` (default "cuda": the card; "cpu" runs the plain versions of
the kernels). They need the `flatbuffers` package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _next_pow2(n: int, minimum: int = 256) -> int:
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


def _memstat(state: dict) -> dict:
    """Per-collection memory analysis of an RDB snapshot: actual snapshot
    array bytes plus projected live host-RAM / HBM footprints using the
    docs/sizing.md formulas (reference analogue: tools/memory_analysis.go —
    the Go heap-analysis tool; here the layout is flat arrays, so the
    analysis is exact arithmetic over the snapshot)."""
    out: dict = {"version": state.get("version"), "databases": {}}
    tot_host = tot_hbm = tot_snap = 0
    for dbname, db in (state.get("databases") or {}).items():
        dbrep: dict = {}
        for cname, col in (db.get("collections") or {}).items():
            g = col.get("graph") or {}
            # sharded snapshots nest one graph dict per shard; aggregate
            # them (a naive top-level read would report ~zero for a
            # collection holding millions of vectors)
            shards = g.get("shards") if g.get("sharded") else None
            graphs = list(shards) if shards else [g]
            kind = graphs[0].get("kind", "hnsw")
            n = sum(int(sg.get("count", 0)) for sg in graphs)
            live = sum(int(sg.get("live", sg.get("count", 0))) for sg in graphs)
            cap = sum(_next_pow2(int(sg.get("count", 0))) for sg in graphs)
            dim = int(graphs[0].get("dim", g.get("dim", 0)) or 0)
            arrays: dict = {}
            for sg in graphs:
                for key in ("vectors", "levels", "deleted", "neighbors0",
                            "slot_to_id"):
                    a = sg.get(key)
                    if a is not None and hasattr(a, "nbytes"):
                        arrays[key] = arrays.get(key, 0) + int(a.nbytes)
                layer_bytes = sum(
                    int(ls["node_slot"].nbytes) + int(ls["nbrs"].nbytes)
                    for ls in sg.get("layers", ())
                    if hasattr(ls.get("node_slot"), "nbytes")
                )
                if layer_bytes:
                    arrays["upper_layers"] = (
                        arrays.get("upper_layers", 0) + layer_bytes
                    )
            snap = sum(arrays.values())
            params = graphs[0].get("params") or {}
            m = int(params.get("m", 16))
            if kind == "flat":
                # vectors f32 + deleted + slot_to_id + id dict
                host = cap * (dim * 4 + 1 + 8 + 90)
                # device: f32 + sq_norms + valid + int8 scan copy + scale
                hbm = cap * (dim * 4 + 4 + 1 + dim + 4)
            else:
                host = cap * (dim * 4 + 2 * m * 4 + 5 + 90) + int(
                    cap * (m * 4 + 8) / max(2 * m - 1, 1)
                )
                hbm = cap * (dim * 4 + 4 + 1 + 2 * m * 4) + cap * 4
            meta = col.get("metadata") or {}
            dbrep[cname] = {
                "kind": kind,
                "shards": len(graphs) if shards else None,
                "count": n,
                "live": live,
                "dim": dim,
                "capacity_next_pow2": cap,
                "snapshot_bytes": snap,
                "snapshot_arrays": arrays,
                "est_host_ram_bytes": int(host),
                "est_hbm_bytes": int(hbm),
                "metadata_entries": len(meta),
            }
            tot_host += host
            tot_hbm += hbm
            tot_snap += snap
        out["databases"][dbname] = dbrep
    out["totals"] = {
        "snapshot_bytes": int(tot_snap),
        "est_host_ram_bytes": int(tot_host),
        "est_hbm_bytes": int(tot_hbm),
    }
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m scintirete_tpu_torch.cli.admin_main"
    )
    parser.add_argument("-data-dir", "--data-dir", default="./data",
                        help="server persistence data directory")
    parser.add_argument("-rdb", "--rdb", default="vector.rdb",
                        help="RDB filename inside the data dir")
    parser.add_argument("-aof", "--aof", default="appendonly.aof",
                        help="AOF filename inside the data dir")
    parser.add_argument("-device", "--device", default="cuda",
                        help="torch device of the engine that "
                        "import-reference and export-reference rebuild")
    sub = parser.add_subparsers(dest="cmd", required=True)

    backup = sub.add_parser("backup", help="manage RDB snapshot backups")
    bsub = backup.add_subparsers(dest="action", required=True)
    bsub.add_parser("create", help="copy the current snapshot to backups/")
    bsub.add_parser("list", help="list existing backups")
    restore = bsub.add_parser("restore", help="restore a backup over the RDB")
    restore.add_argument("path", help="backup file path (from `backup list`)")

    sub.add_parser("inspect", help="print AOF/RDB stats as JSON")

    sub.add_parser(
        "memstat",
        help="per-collection memory analysis of the RDB snapshot "
        "(host RAM / HBM sizing per docs/sizing.md)",
    )

    imp = sub.add_parser(
        "import-reference",
        help="migrate a reference (Go Scintirete) deployment: read its "
        "FlatBuffers .rdb/.aof, rebuild indexes, write OUR snapshot into "
        "-data-dir",
    )
    imp.add_argument("--ref-rdb", default=None,
                     help="reference scintirete.rdb path")
    imp.add_argument("--ref-aof", default=None,
                     help="reference scintirete.aof path")
    imp.add_argument("--index-type", default="hnsw",
                     choices=("hnsw", "flat"),
                     help="index type for imported collections")

    exp = sub.add_parser(
        "export-reference",
        help="write the current snapshot's state as a reference-format "
        "FlatBuffers .rdb (migration back to the Go implementation)",
    )
    exp.add_argument("out", help="output .rdb path")

    args = parser.parse_args(argv)

    from scintirete_tpu_torch.errors import ScintireteError
    from scintirete_tpu_torch.persistence.rdb import BackupManager, RDBManager

    rdb = RDBManager(os.path.join(args.data_dir, args.rdb))
    try:
        if args.cmd == "backup":
            mgr = BackupManager(rdb)
            if args.action == "create":
                dest = mgr.create_backup()
                print(dest)
            elif args.action == "list":
                for path in mgr.list_backups():
                    print(path)
            else:  # restore
                mgr.restore_backup(args.path)
                print(f"restored {args.path} -> {rdb.path}")
        elif args.cmd == "import-reference":
            if not args.ref_rdb and not args.ref_aof:
                print("error: provide --ref-rdb and/or --ref-aof",
                      file=sys.stderr)
                return 1
            from scintirete_tpu_torch.engine import Engine
            from scintirete_tpu_torch.persistence import PersistenceManager
            from scintirete_tpu_torch.persistence import fbcompat

            engine = Engine(device=args.device)
            pm = PersistenceManager(engine, args.data_dir,
                                    rdb_filename=args.rdb,
                                    aof_filename=args.aof)
            try:
                pm.recover()  # merge into an existing data dir if present
                imported = fbcompat.import_reference(
                    engine,
                    rdb_path=args.ref_rdb,
                    aof_path=args.ref_aof,
                    index_type=args.index_type,
                )
                pm.save_snapshot()
            finally:
                pm.stop()
            print(json.dumps({"imported": imported,
                              "snapshot": pm.rdb.path}, indent=2))
        elif args.cmd == "export-reference":
            from scintirete_tpu_torch.engine import Engine
            from scintirete_tpu_torch.persistence import PersistenceManager
            from scintirete_tpu_torch.persistence import fbcompat

            engine = Engine(device=args.device)
            pm = PersistenceManager(engine, args.data_dir,
                                    rdb_filename=args.rdb,
                                    aof_filename=args.aof)
            try:
                pm.recover()
                exported = fbcompat.export_rdb(engine, args.out)
            finally:
                pm.stop()
            print(json.dumps({"exported": exported, "path": args.out},
                             indent=2))
        elif args.cmd == "memstat":
            state = rdb.load()
            if state is None:
                print("no RDB snapshot found", file=sys.stderr)
                return 1
            print(json.dumps(_memstat(state), indent=2))
        else:  # inspect
            aof_path = os.path.join(args.data_dir, args.aof)
            info = {
                "rdb": {
                    "path": rdb.path,
                    "exists": rdb.exists(),
                    "size_bytes": rdb.size_bytes(),
                },
                "aof": {
                    "path": aof_path,
                    "exists": os.path.exists(aof_path),
                    "size_bytes": (
                        os.path.getsize(aof_path)
                        if os.path.exists(aof_path)
                        else 0
                    ),
                },
                "backups": BackupManager(rdb).list_backups(),
            }
            print(json.dumps(info, indent=2))
    except ScintireteError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    except BrokenPipeError:  # output piped into head etc.
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
