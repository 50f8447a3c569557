"""Standalone resource monitor: scintirete-tpu-monitor. Port of
`scintirete_tpu/cli/monitor_main.py`:

    python -m scintirete_tpu_torch.cli.monitor_main -i 5 -n 3 [--device cuda]

Capability parity with the reference's cpu-monitor binary
(reference: cmd/cpu-monitor/main.go:13-45): samples process CPU/memory (and
here, with --device cuda, the card's memory) at an interval and prints one
line per sample.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from scintirete_tpu_torch.observability.logger import StructuredLogger
from scintirete_tpu_torch.observability.monitor import SystemMonitor


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="scintirete-tpu-monitor")
    parser.add_argument("-i", "--interval", type=float, default=5.0)
    parser.add_argument("-n", "--samples", type=int, default=0, help="0 = forever")
    parser.add_argument(
        "--device", default=None,
        help="torch device whose memory to sample too (e.g. cuda)",
    )
    args = parser.parse_args(argv)

    logger = StructuredLogger(level="warn", fmt="text")
    monitor = SystemMonitor(
        logger, interval_seconds=args.interval, device=args.device
    )
    count = 0
    try:
        while args.samples == 0 or count < args.samples:
            sample = monitor.sample_once()
            print(json.dumps(sample, default=str), flush=True)
            count += 1
            if args.samples == 0 or count < args.samples:
                time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
