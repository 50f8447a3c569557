"""Append-only command log. A copy of `scintirete_tpu/persistence/aof.py`
on the port's `serde`.

Capability parity with the reference AOF logger
(reference: internal/persistence/aof/aof.go):

- records are length-prefixed (4-byte little-endian) serialized commands
  (aof.go:115-124); replay validates 0 < len <= 100 MB (aof.go:182-184),
- three sync strategies (aof.go:22-29): "always" (fsync per write),
  "everysec" (1 s background flusher), "no" = smart sync (flush when >= 6 KB
  is buffered or every 5 minutes, aof.go:84-85, :798-823),
- Rewrite writes a temp file then atomically renames (aof.go:219-296),
- Truncate recreates an empty file (aof.go:686-706) — invoked after a
  successful RDB snapshot so the AOF always holds "changes since last
  snapshot".

Fixes the reference's known gap: vector metadata is preserved in AOF records
(the reference writes "{}" — aof/aof.go:530-535 — losing metadata on replay).
"""

from __future__ import annotations

import enum
import os
import struct
import threading
import time
from typing import Any, Callable, Optional

from scintirete_tpu_torch.errors import ErrorCode, ScintireteError
from scintirete_tpu_torch.persistence import serde

_LEN = struct.Struct("<I")
MAX_RECORD_BYTES = 100 * 1024 * 1024
SMART_FLUSH_BYTES = 6 * 1024
SMART_FLUSH_SECONDS = 300.0


class SyncStrategy(str, enum.Enum):
    ALWAYS = "always"
    EVERYSEC = "everysec"
    NO = "no"  # "smart sync" in the reference


class AOFLogger:
    def __init__(self, path: str, strategy: SyncStrategy | str = SyncStrategy.EVERYSEC):
        self.path = path
        self.strategy = SyncStrategy(strategy)
        self._lock = threading.Lock()
        self._buffer = bytearray()
        self._last_flush = time.time()
        self._write_count = 0
        self._closed = False
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "ab")
        self._flusher: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        if self.strategy == SyncStrategy.EVERYSEC:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="aof-everysec", daemon=True
            )
            self._flusher.start()

    # ----- write path -----

    def write_command(self, cmd: dict[str, Any]) -> None:
        payload = serde.dumps(cmd)
        if len(payload) > MAX_RECORD_BYTES:
            raise ScintireteError(
                ErrorCode.PERSISTENCE_FAILED,
                f"AOF record too large: {len(payload)} bytes",
            )
        record = _LEN.pack(len(payload)) + payload
        with self._lock:
            if self._closed:
                raise ScintireteError(
                    ErrorCode.PERSISTENCE_FAILED, "AOF logger is closed"
                )
            self._write_count += 1
            if self.strategy == SyncStrategy.ALWAYS:
                self._fh.write(record)
                self._fh.flush()
                os.fsync(self._fh.fileno())
            elif self.strategy == SyncStrategy.EVERYSEC:
                self._fh.write(record)
            else:  # smart sync
                self._buffer.extend(record)
                now = time.time()
                if (
                    len(self._buffer) >= SMART_FLUSH_BYTES
                    or now - self._last_flush >= SMART_FLUSH_SECONDS
                ):
                    self._drain_buffer_locked()

    def _drain_buffer_locked(self) -> None:
        if self._buffer:
            self._fh.write(bytes(self._buffer))
            self._buffer.clear()
        self._fh.flush()
        self._last_flush = time.time()

    def _flush_loop(self) -> None:
        errors = 0
        while not self._stop_event.wait(1.0):
            with self._lock:
                if self._closed:
                    return
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    errors = 0
                except ValueError:
                    return  # file handle closed under us: done
                except OSError as exc:
                    # a TRANSIENT fsync error (momentary ENOSPC/EIO) must
                    # not kill the everysec thread for the process
                    # lifetime — that silently widens the advertised ~1 s
                    # loss window to unbounded. Log and keep trying.
                    errors += 1
                    if errors in (1, 10) or errors % 600 == 0:
                        import logging

                        logging.getLogger("scintirete.aof").error(
                            "everysec fsync failed (%d consecutive): %s",
                            errors, exc,
                        )

    def flush(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._drain_buffer_locked()
            os.fsync(self._fh.fileno())

    # ----- replay -----

    def replay(
        self,
        handler: Callable[[dict[str, Any]], None],
        salvage: bool = False,
        on_salvage: Callable[[dict[str, Any]], None] | None = None,
    ) -> int:
        """Scan the log and feed each command to `handler`; returns the
        number applied. Corruption -> CORRUPTED_DATA (reference:
        aof.go:149-216).

        ``salvage=True`` selects the reference's degraded-recovery policy
        (persistence.go:185-305 warns and preserves instead of failing): a
        corrupt TAIL — truncated prefix/body or an undecodable record, the
        signature of a crash mid-append — stops the replay at the last good
        record, preserves the original file as ``<path>.corrupt-<ts>``, and
        truncates the live log to the good prefix so subsequent appends
        produce a valid file. ``on_salvage`` receives a detail dict.
        """
        with self._lock:
            self._drain_buffer_locked()
        count = 0
        good_end = 0
        error: ScintireteError | None = None
        try:
            fh = open(self.path, "rb")
        except FileNotFoundError:
            return 0
        with fh:
            while True:
                head = fh.read(_LEN.size)
                if not head:
                    break
                if len(head) < _LEN.size:
                    error = ScintireteError(
                        ErrorCode.CORRUPTED_DATA, "AOF truncated length prefix"
                    )
                    break
                (length,) = _LEN.unpack(head)
                if length == 0 or length > MAX_RECORD_BYTES:
                    error = ScintireteError(
                        ErrorCode.CORRUPTED_DATA,
                        f"AOF record length out of range: {length}",
                    )
                    break
                payload = fh.read(length)
                if len(payload) < length:
                    error = ScintireteError(
                        ErrorCode.CORRUPTED_DATA, "AOF truncated record body"
                    )
                    break
                try:
                    cmd = serde.loads(payload)
                except Exception as exc:
                    error = ScintireteError(
                        ErrorCode.CORRUPTED_DATA, f"AOF undecodable record: {exc}"
                    )
                    break
                handler(cmd)
                count += 1
                good_end = fh.tell()
        if error is None:
            return count
        if not salvage:
            raise error
        detail = self._salvage_tail(good_end, str(error), count)
        if on_salvage is not None:
            on_salvage(detail)
        return count

    def _salvage_tail(self, good_end: int, reason: str, count: int) -> dict:
        """Preserve the corrupt file, then truncate the live log to the
        good prefix. The append handle stays valid: O_APPEND writes land at
        the new end."""
        import shutil

        with self._lock:
            self._fh.flush()
            total = os.path.getsize(self.path)
            preserved = f"{self.path}.corrupt-{int(time.time())}"
            shutil.copyfile(self.path, preserved)
            with open(self.path, "r+b") as t:
                t.truncate(good_end)
        return {
            "reason": reason,
            "replayed": count,
            "good_bytes": good_end,
            "dropped_bytes": total - good_end,
            "preserved_as": preserved,
        }

    # ----- maintenance -----

    def rewrite(self, commands: list[dict[str, Any]]) -> None:
        """Replace the log with a compacted command stream, atomically
        (reference: aof.go:219-296 — temp file + rename)."""
        tmp = self.path + ".rewrite.tmp"
        with open(tmp, "wb") as fh:
            for cmd in commands:
                payload = serde.dumps(cmd)
                fh.write(_LEN.pack(len(payload)))
                fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        with self._lock:
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "ab")
            self._buffer.clear()
            self._last_flush = time.time()

    def truncate(self) -> None:
        """Empty the log (after a successful snapshot, reference: aof.go:686-706)."""
        with self._lock:
            self._fh.close()
            self._fh = open(self.path, "wb")
            self._fh.close()
            self._fh = open(self.path, "ab")
            self._buffer.clear()
            self._last_flush = time.time()

    def size_bytes(self) -> int:
        with self._lock:
            if not self._closed:
                self._fh.flush()
        try:
            return os.path.getsize(self.path)
        except FileNotFoundError:
            return 0

    def stats(self) -> dict[str, Any]:
        return {
            "path": self.path,
            "strategy": self.strategy.value,
            "size_bytes": self.size_bytes(),
            "write_count": self._write_count,
        }

    def close(self) -> None:
        """Final flush + fsync (reference: aof.go:709-734)."""
        self._stop_event.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
        with self._lock:
            if self._closed:
                return
            self._drain_buffer_locked()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._closed = True
