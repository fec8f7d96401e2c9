"""Host spans of the serving path: the one tracing system of the port.

Off by default. :func:`span` then returns the shared :data:`NULL` after
reading one global: no clock, no record, no context variable, no
profiler call. :func:`enable` turns recording on; each span
that ends appends one tuple to an in-memory buffer of fixed capacity::

    (sid, parent, name, t0_ns, t1_ns, tid, attrs)

``t0_ns`` and ``t1_ns`` are ``time.perf_counter_ns()``, the clock of
``engine.WallClock``; ``parent`` is the enclosing span's ``sid`` (None
for a root); ``tid`` is the thread that opened the span; ``attrs`` is a
dict. A span with no ``step`` of its own takes its parent's, so the
executor's spans carry the router's step number. Spans past the capacity
are counted by :func:`dropped` and not kept. :func:`drain` hands the
buffer over and empties it; nothing is written out on the hot path
(:func:`to_chrome` formats what was drained).

The parent is the span current in the caller's ``contextvars`` context,
so it survives ``asyncio.to_thread`` into a worker thread; ``parent=``
names it explicitly (``None``: a root). Where the torch profiler records
the current thread, a ``with`` span also enters
``torch.profiler.record_function(name)``, which puts it into the
profiler's host timeline beside the card's kernels.

The counters of builds, captures and launches stay in ``compat``.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["NULL", "Span", "span", "enable", "disable", "enabled",
           "drain", "dropped", "self_ns", "to_chrome"]

Record = Tuple[int, Optional[int], str, int, int, int, Dict[str, Any]]

_on = False
_capacity = 0
_buf: List[Record] = []
_dropped = 0
_lock = threading.Lock()           # the buffer, the count of dropped spans
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_span", default=None)
_profiling = None                  # the profiler's per-thread enabled check
_record_function = None

# ``parent=`` left out: the span current in the caller's context
_CONTEXT = object()


class _Null:
    """What every span call returns while tracing is off: a reusable
    context manager whose methods do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass

    def end(self, **attrs) -> None:
        pass


NULL = _Null()


class Span:
    """One open span. As a context manager it is the current span of its
    context until it exits; :meth:`end` records it (once), also before
    the ``with`` block exits, which then only restores the context."""

    __slots__ = ("sid", "parent", "name", "t0", "t1", "tid", "attrs",
                 "_token", "_rf")

    def __init__(self, name: str, parent, attrs: Dict[str, Any]):
        if parent is _CONTEXT:
            parent = _current.get()
        parent = parent or None        # a NULL opened before enable()
        if parent is not None and "step" not in attrs \
                and "step" in parent.attrs:
            attrs["step"] = parent.attrs["step"]
        self.sid = next(_ids)
        self.parent = parent.sid if parent is not None else None
        self.name = name
        self.tid = threading.get_ident()
        self.attrs = attrs
        self.t1 = None
        self._token = None
        self._rf = None
        self.t0 = time.perf_counter_ns()

    def __enter__(self):
        self._token = _current.set(self)
        if _profiling():
            self._rf = _record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.end()
        _current.reset(self._token)
        return None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        global _dropped
        if self.t1 is not None:
            return
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if attrs:
            self.attrs.update(attrs)
        with _lock:
            if len(_buf) < _capacity:
                _buf.append((self.sid, self.parent, self.name, self.t0,
                             self.t1, self.tid, self.attrs))
            else:
                _dropped += 1


def span(name: str, parent=_CONTEXT, **attrs):
    """A span started now; :data:`NULL` while tracing is off. Used in a
    ``with`` statement it is the current span inside the block and ends
    with it; otherwise it ends at its ``end()``, wherever that is called,
    and is never current."""
    if not _on:
        return NULL
    return Span(name, parent, attrs)


def enable(capacity: int = 1 << 20) -> None:
    """Record spans from now on, keeping at most ``capacity`` of them
    until the next :func:`drain`."""
    global _on, _capacity, _profiling, _record_function
    if capacity < 1:
        raise ValueError(f"capacity must be positive, got {capacity}")
    import torch
    _profiling = torch._C._autograd._profiler_enabled
    _record_function = torch.profiler.record_function
    _capacity = int(capacity)
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`drain`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> List[Record]:
    """The spans recorded since the last drain, in the order they ended;
    the buffer and the count of dropped spans start again empty."""
    global _buf, _dropped
    with _lock:
        out, _buf = _buf, []
        _dropped = 0
    return out


def dropped() -> int:
    """Spans not kept since the last drain because the buffer was full."""
    return _dropped


def self_ns(rec: Record, children: List[Record]) -> int:
    """``rec``'s duration less the part of it its ``children`` cover."""
    t0, t1 = rec[3], rec[4]
    covered, end = 0, t0
    for c in sorted(children, key=lambda c: c[3]):
        a, b = max(c[3], end), min(c[4], t1)
        if b > a:
            covered += b - a
            end = b
    return t1 - t0 - covered


def to_chrome(spans: List[Record], pid: int = 0) -> Dict[str, Any]:
    """Drained spans as Chrome trace-event JSON (``chrome://tracing``,
    Perfetto): one complete event a span, times in microseconds."""
    events = [{"name": name, "ph": "X", "pid": pid, "tid": tid,
               "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
               "args": {"sid": sid, "parent": parent, **attrs}}
              for sid, parent, name, t0, t1, tid, attrs in spans]
    return {"traceEvents": events, "displayTimeUnit": "ms"}
