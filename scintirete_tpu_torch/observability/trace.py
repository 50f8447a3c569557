"""The port's own spans: where a request and a bulk build spend their time.

One tracer per process, switched only by code (`enable()`, `disable()`,
`drain()`) and by the server's `-trace DIR` flag; no config field or
environment variable turns it on. Off, `span()` hands back one shared
no-op context manager and records nothing.

A span (`Span`) records:
- its name, and an optional `attr` (the RPC method of `service.call`);
- start and end on `time.monotonic_ns()`. The profiler's events are on the
  wall clock; `offset_ns` (`time.time_ns() - time.monotonic_ns()`, read at
  `enable()`) moves one onto the other, so spans and device events share
  one time base;
- the thread's CPU time at both ends (`time.thread_time_ns()`): wall time
  less CPU time is time spent waiting (the GIL, a lock, a device sync);
- its own id and its parent's (the innermost span open on its thread; 0
  for none);
- the request it belongs to: the one set on its thread (`set_request`,
  done by the gRPC transport for a call's handler and encoder), the one
  passed in (`span(..., request=...)`: the decoder, which gRPC runs on its
  own polling thread), else, for a span opened on a thread with none, a
  request of its own that the spans inside it share;
- the thread's native id (the profiler's `tid`);
- an optional count `n` (queries, rows).

Spans are kept in memory, at most `capacity` of them; what does not fit
is counted in `dropped` and not kept, so that a reader can tell a partial
record from a whole one.

`timed(name)` is a span that times itself whether or not the tracer is on
(`seconds` once it has closed, `elapsed_s()` while open): the bulk build's
`build_stats` and the service's request-duration histogram take their
seconds from it, so each boundary has one clock.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import NamedTuple, Optional

DEFAULT_CAPACITY = 1 << 20
# the exported spans' process in a Chrome trace: above any Linux pid
# (pid_max is at most 2^22), so the spans get a track of their own
CHROME_PID = 1 << 30


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    cpu_start_ns: int
    cpu_end_ns: int
    id: int
    parent: int
    request: Optional[int]
    thread: int
    n: Optional[int]
    attr: Optional[str]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def cpu_seconds(self) -> float:
        return (self.cpu_end_ns - self.cpu_start_ns) / 1e9


class Drained(NamedTuple):
    spans: list[Span]
    dropped: int
    offset_ns: int  # wall clock less monotonic clock, read at enable()


class _ThreadState(threading.local):
    def __init__(self):
        self.stack: list[_Span] = []
        self.request: Optional[int] = None
        self.thread = threading.get_native_id()


class _NoSpan:
    """The shared span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_tracer", "name", "n", "attr", "start_ns", "end_ns",
                 "_cpu0", "_id", "_parent", "_request", "_owns_request",
                 "_state", "_record")

    def __init__(self, tracer: "Tracer", name: str, n: Optional[int],
                 attr: Optional[str], request: Optional[int], record: bool):
        self._tracer = tracer
        self.name = name
        self.n = n
        self.attr = attr
        self._request = request
        self._record = record
        self.end_ns = 0

    def __enter__(self):
        if self._record:
            tracer = self._tracer
            state = tracer._state
            stack = state.stack
            self._state = state
            self._parent = stack[-1]._id if stack else 0
            self._owns_request = False
            if self._request is None:
                if state.request is None:
                    state.request = next(tracer._ids)
                    self._owns_request = True
                self._request = state.request
            self._id = next(tracer._ids)
            stack.append(self)
            self._cpu0 = time.thread_time_ns()
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.monotonic_ns()
        if self._record:
            cpu1 = time.thread_time_ns()
            state = self._state
            state.stack.pop()
            if self._owns_request:
                state.request = None
            self._tracer._keep(Span(
                self.name, self.start_ns, self.end_ns, self._cpu0, cpu1,
                self._id, self._parent, self._request, state.thread,
                self.n, self.attr))
        return None

    def elapsed_s(self) -> float:
        return (time.monotonic_ns() - self.start_ns) / 1e9

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Tracer:
    def __init__(self):
        self.enabled = False
        self.capacity = DEFAULT_CAPACITY
        self.offset_ns = 0
        self._spans: list[Span] = []
        self._dropped = 0
        self._mu = threading.Lock()
        self._ids = itertools.count(1)
        self._state = _ThreadState()

    def enable(self) -> None:
        with self._mu:
            self.offset_ns = time.time_ns() - time.monotonic_ns()
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def drain(self) -> Drained:
        """The spans kept since the last drain, and how many did not fit."""
        with self._mu:
            out = Drained(self._spans, self._dropped, self.offset_ns)
            self._spans, self._dropped = [], 0
        return out

    def _keep(self, span: Span) -> None:
        with self._mu:
            if len(self._spans) < self.capacity:
                self._spans.append(span)
            else:
                self._dropped += 1

    def span(self, name: str, n: Optional[int] = None,
             attr: Optional[str] = None, request: Optional[int] = None):
        if not self.enabled:
            return NO_SPAN
        return _Span(self, name, n, attr, request, True)

    def timed(self, name: str, attr: Optional[str] = None) -> _Span:
        return _Span(self, name, None, attr, None, self.enabled)

    def new_request(self) -> Optional[int]:
        """A fresh request id, or None with the tracer off."""
        return next(self._ids) if self.enabled else None

    def set_request(self, request: Optional[int]) -> None:
        """The request the spans opened on this thread belong to from now
        on (None: none)."""
        self._state.request = request


TRACER = Tracer()

enable = TRACER.enable
disable = TRACER.disable
drain = TRACER.drain
span = TRACER.span
timed = TRACER.timed
new_request = TRACER.new_request
set_request = TRACER.set_request


def add_to_chrome_trace(path: str, drained: Drained) -> int:
    """Append the drained spans to the Chrome trace at `path` (as
    `torch.profiler`'s `export_chrome_trace` writes it) as complete
    events ("X") in a process of their own, one track per thread, in the
    file's time base (`ts` in microseconds after its
    `baseTimeNanoseconds` on the wall clock), so that both open aligned
    in one viewer. Returns the number of spans written."""
    with open(path) as fh:
        doc = json.load(fh)
    shift = drained.offset_ns - int(doc.get("baseTimeNanoseconds", 0))
    events = doc["traceEvents"]
    events.append({"ph": "M", "name": "process_name", "pid": CHROME_PID,
                   "args": {"name": "scintirete spans"}})
    for s in drained.spans:
        args = {"id": s.id, "parent": s.parent, "request": s.request,
                "cpu_us": (s.cpu_end_ns - s.cpu_start_ns) / 1e3}
        if s.n is not None:
            args["n"] = s.n
        if s.attr is not None:
            args["attr"] = s.attr
        events.append({
            "ph": "X", "cat": "span", "name": s.name, "pid": CHROME_PID,
            "tid": s.thread, "ts": (s.start_ns + shift) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "args": args,
        })
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(drained.spans)
