"""Server: scintirete-tpu-server on the port. Port of
`scintirete_tpu/cli/server_main.py`:

    python -m scintirete_tpu_torch.cli.server_main -config <toml> [-device cuda|cpu]

Capability parity with the reference server main
(reference: cmd/scintirete-server/main.go:38-171): flags -config,
-log-level; composition of engine + persistence + embedding + auth +
observability; recovery on start; gRPC + HTTP + metrics listeners;
SIGINT/SIGTERM graceful shutdown with a final fsync. Once it listens it
logs a "startup" line: the wall-clock time main() began and the seconds
of the imports inside it, of the recovery and of starting the listeners.

The engine runs on `-device`: by default `[tpu] platform` of the config,
and the card ("cuda") when that is empty; "cuda" without a card fails at
start, with no fallback to the CPU. `--no-device` keeps every search and
insert on the host paths. `-trace DIR` records a `torch.profiler` trace
over the server's life and writes it to DIR at shutdown (the reference's
`runtime/trace`-to-file flag, cmd/scintirete-server/main.go:60-87).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time

from scintirete_tpu_torch.config import load_config
from scintirete_tpu_torch.errors import ScintireteError
from scintirete_tpu_torch.observability.audit import AuditLogger
from scintirete_tpu_torch.observability.logger import StructuredLogger
from scintirete_tpu_torch.observability.metrics import (
    MetricsRegistry,
    MetricsServer,
)
from scintirete_tpu_torch.observability.monitor import SystemMonitor


def start_trace(device: str):
    """A running torch.profiler over the host and, on the card, CUDA."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="scintirete-tpu-server",
        description="Vector database server on PyTorch / CUDA "
        "(Scintirete capability parity)",
    )
    parser.add_argument("-config", "--config", default=None, help="TOML config path")
    parser.add_argument(
        "-log-level", "--log-level", dest="log_level", default=None,
        help="override log level (debug/info/warn/error)",
    )
    parser.add_argument(
        "-device", "--device", choices=("cuda", "cpu"), default=None,
        help="torch device of the engine (default: [tpu] platform, "
        "else cuda)",
    )
    parser.add_argument(
        "-trace", "--trace", default=None, metavar="DIR",
        help="record a torch.profiler trace over the server's life and "
        "write it to DIR/trace.json at shutdown",
    )
    parser.add_argument(
        "--no-device", action="store_true",
        help="host-only mode (no device dispatch); for development",
    )
    args = parser.parse_args(argv)
    t_main = time.time()

    try:
        cfg = load_config(args.config)
    except ScintireteError as exc:
        # reference main.go: bad config is a one-line fatal, not a traceback
        print(f"failed to load config: {exc}", file=sys.stderr)
        return 1
    if args.log_level:
        cfg.log.level = args.log_level
    logger = StructuredLogger.from_config(cfg.log)
    device = args.device or cfg.tpu.platform or "cuda"

    prof = None
    if args.trace:
        prof = start_trace(device)
        logger.info("torch profiler recording", dir=args.trace)

    audit = AuditLogger(
        path=os.path.join(cfg.persistence.data_dir, "audit.log"),
        enabled=cfg.log.enable_audit_log,
    )
    metrics = MetricsRegistry()

    t0 = time.perf_counter()
    from scintirete_tpu_torch.server.grpc_server import GrpcServer
    from scintirete_tpu_torch.server.http_server import HttpGateway
    from scintirete_tpu_torch.server.service import ScintireteService

    imports_s = time.perf_counter() - t0

    service = ScintireteService(
        cfg,
        logger=logger,
        audit=audit,
        metrics=metrics,
        use_device=not args.no_device,
        device=device,
    )
    t0 = time.perf_counter()
    recovery = service.start()
    recovery_s = time.perf_counter() - t0
    logger.info("recovery", device=device, **recovery)
    t0 = time.perf_counter()

    grpc_server = GrpcServer(service, cfg.server.grpc_host, cfg.server.grpc_port)
    grpc_server.start()
    logger.info("gRPC listening", address=f"{cfg.server.grpc_host}:{grpc_server.port}")

    http_gateway = HttpGateway(service, cfg.server.http_host, cfg.server.http_port)
    http_gateway.start()
    logger.info(
        "HTTP listening", address=f"{cfg.server.http_host}:{http_gateway.port}"
    )
    logger.info("startup", main_start=t_main, imports_s=imports_s,
                recovery_s=recovery_s, listen_s=time.perf_counter() - t0,
                listening=time.time())

    metrics_server = None
    if cfg.observability.metrics_enabled:
        metrics_server = MetricsServer(
            metrics,
            cfg.server.http_host,
            cfg.observability.metrics_port,
            cfg.observability.metrics_path,
        )
        metrics_server.start()
        logger.info("metrics listening", port=metrics_server.port)

    monitor = SystemMonitor(
        logger,
        interval_seconds=cfg.monitoring.interval,
        cpu_threshold=cfg.monitoring.cpu_threshold,
        memory_threshold_bytes=cfg.monitoring.memory_threshold * 1024 * 1024,
        enabled=cfg.monitoring.enabled,
        # --no-device must hold: sampling the card's memory would create
        # a CUDA context in host-only mode
        device=None if args.no_device else device,
        cpu_enabled=cfg.monitoring.cpu_enabled,
        memory_enabled=cfg.monitoring.memory_enabled,
        disk_enabled=cfg.monitoring.disk_enabled,
        disk_threshold_bytes=cfg.monitoring.disk_threshold * 1024 * 1024,
        disk_path=cfg.persistence.data_dir,
    )
    monitor.start()

    stop_event = threading.Event()

    def handle_signal(signum, frame):
        logger.info("shutdown signal received", signal=signum)
        stop_event.set()

    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGTERM, handle_signal)

    stop_event.wait()
    if prof is not None:
        prof.stop()
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("torch profiler trace written", path=path)
    monitor.stop()
    grpc_server.stop()
    http_gateway.stop()
    if metrics_server:
        metrics_server.stop()
    service.stop()  # persistence stop -> final fsync
    logger.info("server stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
