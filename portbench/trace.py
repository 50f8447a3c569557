"""What a traced run (`--trace 1`) records, and its reduction.

- Spans: the harness wraps program entry points from outside (an
  attribute of an object or a module, replaced by a timing wrapper) and
  keeps (name, start, end) on the monotonic clock in memory for the whole
  window.
- Kernel calls: the Python wrapper of each kernel that the cell's own
  per-layer readers name (their `ROOFLINES`, each a `roofline/` file) is
  wrapped the same way and keeps the shapes of its calls while the device
  trace runs.
- The device trace: `torch.profiler` runs from before the window to after
  it; the events of a steady stretch in the window's middle are kept. Its
  timestamps are on the wall clock in nanoseconds; they are moved onto
  the monotonic clock by the offset between the two, read at its start.

No timing here touches the untraced run: it installs nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, Callable, Optional


class Spans:
    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self._undo: list[tuple[Any, str, Any]] = []

    def wrap(self, obj: Any, attr: str, name: str) -> None:
        orig = getattr(obj, attr)
        items = self.items

        @functools.wraps(orig)
        def timed(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return orig(*args, **kwargs)
            finally:
                items.append((name, t0, time.monotonic()))

        self._undo.append((obj, attr, orig))
        setattr(obj, attr, timed)

    def of(self, name: str, lo: float = float("-inf"),
           hi: float = float("inf")) -> list[tuple[float, float]]:
        """Intervals of `name` that started in [lo, hi)."""
        return [(a, b) for n, a, b in self.items if n == name and lo <= a < hi]

    def unwrap(self) -> None:
        for obj, attr, orig in reversed(self._undo):
            setattr(obj, attr, orig)
        self._undo.clear()


class KernelCalls:
    """Shapes of the calls of each wrapped kernel while `on`."""

    def __init__(self):
        self.on = False
        self.shapes: dict[str, list[dict]] = collections.defaultdict(list)
        self._undo: list[tuple[Any, str, Any]] = []

    def wrap(self, module: Any, attr: str, kernel: str,
             shape_of: Callable[..., dict]) -> None:
        orig = getattr(module, attr)
        calls = self

        @functools.wraps(orig)
        def recorded(*args, **kwargs):
            if calls.on:
                calls.shapes[kernel].append(shape_of(*args, **kwargs))
            return orig(*args, **kwargs)

        self._undo.append((module, attr, orig))
        setattr(module, attr, recorded)

    def unwrap(self) -> None:
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()


@dataclasses.dataclass
class DeviceTrace:
    start: float  # monotonic seconds
    end: float
    events: list[tuple[str, float, float]]  # (name, start, end), clipped
    raw: int = 0  # device events in the profile, before clipping
    # the first raw event's start less the stretch's start, and the last's
    # less its end (seconds): how the profile covers the stretch
    reach: Optional[tuple[float, float]] = None

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the intervals of kernels, copies and sets)."""
        busy, reach = 0.0, self.start
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            a = max(a, reach)
            if b > a:
                busy += b - a
                reach = b
        return busy

    def gaps(self) -> list[tuple[float, float]]:
        """Intervals of the stretch in which nothing ran on the device."""
        out, reach = [], self.start
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            if a > reach:
                out.append((reach, a))
            reach = max(reach, b)
        if self.end > reach:
            out.append((reach, self.end))
        return out

    def seconds_of(self, patterns: tuple[str, ...]) -> float:
        return sum(b - a for n, a, b in self.events
                   if any(p in n for p in patterns))

    def by_name(self) -> dict[str, float]:
        out: dict[str, float] = collections.defaultdict(float)
        for n, a, b in self.events:
            out[n] += b - a
        return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list, at most 160 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return (name.split("(", 1)[0].strip() or name)[:160]


class DeviceProfile:
    """`torch.profiler` (CUDA activity) started before the window and
    stopped after it, so that its own start and stop, which hold up the
    serving threads for seconds, fall outside the window; only the
    events of the traced stretch are kept."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.stretch_at: Optional[tuple[float, float]] = None
        self.seconds: dict[str, float] = {}

    def start(self) -> None:
        t = time.monotonic()
        self.prof.start()
        self.offset_ns = time.time_ns() - time.monotonic_ns()
        self.seconds["start"] = time.monotonic() - t

    def stretch(self, seconds: float, calls: Optional[KernelCalls]) -> None:
        """Mark the next `seconds` as the traced stretch (the caller
        sleeps through it), with the kernel calls' shapes recorded."""
        if calls is not None:
            calls.on = True
        start = time.monotonic()
        time.sleep(seconds)
        self.stretch_at = (start, time.monotonic())
        if calls is not None:
            calls.on = False

    def stop(self) -> DeviceTrace:
        import torch

        torch.cuda.synchronize()
        t = time.monotonic()
        self.prof.stop()
        self.seconds["stop"] = time.monotonic() - t
        start, end = self.stretch_at
        events, raw = [], []
        for name, a_ns, b_ns in _raw_events(self.prof):
            a, b = (a_ns - self.offset_ns) / 1e9, (b_ns - self.offset_ns) / 1e9
            raw.append(a)
            a, b = max(a, start), min(b, end)
            if b > a:
                events.append((short_name(name), a, b))
        reach = (min(raw) - start, max(raw) - end) if raw else None
        return DeviceTrace(start, end, events, len(raw), reach)


def _raw_events(prof):
    """(name, start_ns, end_ns) of the device's events (kernels, copies,
    sets) in the profile, on the wall clock."""
    from torch.autograd import DeviceType

    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            yield ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns()
