"""System resource monitor.

Capability parity with the reference monitor
(reference: internal/monitoring/system_monitor.go:14-110, cpu_monitor.go):
a periodic sampler (default 30 s) of process CPU and memory with
configurable warning thresholds, off by default. Port of
`scintirete_tpu/observability/monitor.py`: when the monitor is given a
CUDA device, the card's memory is sampled too (`torch.cuda`).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional


def sample_process_stats() -> dict[str, Any]:
    """Host process stats from /proc (Linux) with a resource-module fallback."""
    stats: dict[str, Any] = {"timestamp": time.time()}
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        stats["rss_bytes"] = pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        import resource

        stats["rss_bytes"] = (
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        )
    stats["cpu_seconds"] = sum(os.times()[:2])
    stats["threads"] = threading.active_count()
    return stats


def sample_device_stats(device) -> Optional[dict[str, Any]]:
    """Memory of a CUDA device: the bytes torch's allocator holds for
    tensors and the card's free and total bytes. None for any other
    device (the host's memory is in sample_process_stats)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    return {
        "device": torch.cuda.get_device_name(dev),
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "bytes_free": free,
        "bytes_limit": total,
    }


class SystemMonitor:
    def __init__(
        self,
        logger,
        interval_seconds: float = 30.0,
        cpu_threshold: float = 0.8,
        memory_threshold_bytes: int = 1024 * 1024 * 1024,
        enabled: bool = False,
        device=None,
        cpu_enabled: bool = True,
        memory_enabled: bool = True,
        disk_enabled: bool = False,
        disk_threshold_bytes: int = 10 * 1024 * 1024 * 1024,
        disk_path: str = ".",
    ):
        self.logger = logger
        # clamp: interval<=0 would make _loop's Event.wait(0) busy-spin,
        # pegging the (1-core) serving box
        self.interval = max(float(interval_seconds), 1.0)
        self.cpu_threshold = cpu_threshold
        self.memory_threshold_bytes = memory_threshold_bytes
        self.enabled = enabled
        # the torch device whose memory each sample reads (None: none)
        self.device = device
        self.cpu_enabled = cpu_enabled
        self.memory_enabled = memory_enabled
        self.disk_enabled = disk_enabled
        self.disk_threshold_bytes = disk_threshold_bytes
        self.disk_path = disk_path
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # baseline from current process counters so the first sample's
        # utilization covers only the first interval, not process lifetime
        self._last_cpu = sum(os.times()[:2])
        self._last_ts = time.time()
        self.last_sample: Optional[dict[str, Any]] = None

    def sample_once(self) -> dict[str, Any]:
        stats = sample_process_stats()
        now = stats["timestamp"]
        dt = max(now - self._last_ts, 1e-9)
        cpu_util = (stats["cpu_seconds"] - self._last_cpu) / dt
        self._last_cpu = stats["cpu_seconds"]
        self._last_ts = now
        stats["cpu_utilization"] = cpu_util
        if self.device is not None:
            dev = sample_device_stats(self.device)
            if dev:
                stats["device"] = dev
        self.last_sample = stats

        if self.disk_enabled:
            try:
                import shutil

                du = shutil.disk_usage(self.disk_path)
                stats["disk_used_bytes"] = du.used
                stats["disk_free_bytes"] = du.free
                if du.used > self.disk_threshold_bytes:
                    self.logger.warn(
                        "disk usage above threshold",
                        used_mb=du.used // (1024 * 1024),
                        threshold_mb=self.disk_threshold_bytes
                        // (1024 * 1024),
                        path=self.disk_path,
                    )
            except OSError:
                pass

        if self.cpu_enabled and cpu_util > self.cpu_threshold:
            self.logger.warn(
                "cpu utilization above threshold",
                utilization=round(cpu_util, 3),
                threshold=self.cpu_threshold,
            )
        if (
            self.memory_enabled
            and stats["rss_bytes"] > self.memory_threshold_bytes
        ):
            self.logger.warn(
                "memory usage above threshold",
                rss_mb=stats["rss_bytes"] // (1024 * 1024),
                threshold_mb=self.memory_threshold_bytes // (1024 * 1024),
            )
        return stats

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="system-monitor", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample_once()
            except Exception as exc:  # pragma: no cover
                self.logger.error("monitor sample failed", error=str(exc))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
