"""Tracing and profiling: the port's stage spans and its trace exporter.

`span(name, device=None)` marks a stage of the program: ``with
span("slam.outlier"): ...``.  It does nothing unless a ``torch.profiler``
session is collecting (`trace` below, or any profiler a caller runs): one
test of the profiler's flag, no allocation, no CUDA call.  While one is:

* the span is a host event of the profiler's own trace (a function-scope
  RecordFunction, an ordinary CPU event and no user annotation, so nothing
  of it is mirrored onto the device timeline), on the clock of the trace's
  device events and nested under the span it was opened in;
* on a CUDA device, outside a graph capture, one timing event on the
  device's current stream at its exit (and at a root's entry) bounds its
  interval on the device in stream order: from where its parent had got
  to when it opened (the parent's start, or the exit of the sibling that
  closed last) to its exit.  Work of the parent between two of its
  children thus counts to the later child: a stage's interval depends on
  where the spans are placed.  The device is the ``device`` argument, or
  the enclosing span's, whose stream a span on the same device takes.
  A span opened with ``own_start=True`` records a timing event at its
  entry as well and starts its interval there, so the parent's work before
  it counts to none of its stages (the detector's ``detect.attention``);
* a `Span` record is kept in memory (at most `MAX_RECORDS`), with the
  counts added inside it by ``span.count(key, n)``.

`spans()` returns the records of the closed spans and `clear_spans()`
forgets them, with their events: whoever reads them clears them.  A
record's device interval is read (`Span.device_ms`) after the traced
window, when its events have completed: never during a step.  It holds
the time the device waited inside the stage too; the trace's idle gaps
while the host was inside the span measure that wait.

`trace` wraps ``torch.profiler`` and writes a Chrome / TensorBoard trace of
the CPU and CUDA activity, the spans among it, into a directory.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

MAX_RECORDS = 1 << 16          # records kept between two readings; later spans keep none
_RECORDS: list = []            # closed spans, in the order they closed
_LOCAL = threading.local()     # each thread's stack of open spans


class Span:
    """The record of a span: its ``name``, the ``parent`` record (None for a
    root), the ``counts`` added inside it, and on a card ``start`` and
    ``end``, the timing events that bound its interval on the device (None
    off a card or inside a capture)."""

    __slots__ = ("name", "parent", "device", "stream", "counts", "start", "end", "own_start", "_mark", "_host")

    def __init__(self, name: str, parent: "Span | None", device, stream, own_start: bool = False):
        self.name, self.parent, self.device, self.stream = name, parent, device, stream
        self.own_start = own_start
        self.counts: dict[str, int] = {}
        self.start = self.end = self._mark = self._host = None

    def device_ms(self) -> float | None:
        """Milliseconds between the bounding events on the device."""
        return None if self.end is None else self.start.elapsed_time(self.end)

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record(self.stream)
        return e

    def __enter__(self) -> "Span":
        _stack().append(self)
        self._host = _RecordFunctionFast(self.name)
        self._host.__enter__()
        if self.stream is not None:
            parent = self.parent
            self.start = self._mark = (parent._mark if parent is not None and parent.stream is self.stream
                                       and not self.own_start else self._event())
        return self

    def __exit__(self, *exc) -> bool:
        if self.stream is not None:
            self.end = self._event()
            if self.parent is not None and self.parent.stream is self.stream:
                self.parent._mark = self.end
        self._host.__exit__(None, None, None)
        self._host = self._mark = None
        _stack().pop()
        if len(_RECORDS) < MAX_RECORDS:
            _RECORDS.append(self)
        return False


class _Off:
    """What `span` returns while no profiler collects."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str, device=None, own_start: bool = False):
    """A stage span (see the module docstring).  ``name`` is dotted, as
    ``slam.outlier``; ``device`` is where the stage's work runs (None: the
    enclosing span's; a span with neither keeps no device interval).  A
    span on its parent's device records on the stream the parent found.
    ``own_start``: the interval starts at the span's own entry event."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    stack = _stack()
    parent = stack[-1] if stack else None
    if parent is not None and (device is None or torch.device(device) == parent.device):
        return Span(name, parent, parent.device, parent.stream, own_start)
    if device is None:
        return Span(name, parent, None, None, own_start)
    device = torch.device(device)
    stream = None
    if device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
        stream = torch.cuda.current_stream(device)
    return Span(name, parent, device, stream, own_start)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to the ``key`` count of the innermost open span (nothing
    while no profiler collects, or outside every span)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[key] = counts.get(key, 0) + n


span.count = count


def spans() -> list:
    """The closed spans' records, in the order they closed."""
    return list(_RECORDS)


def clear_spans() -> None:
    _RECORDS.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` scope over the CPU and, where there is one, the
    card; on exit the trace is written to ``log_dir`` as a Chrome trace
    (``trace_<pid>.json``; chrome://tracing, Perfetto or TensorBoard's
    profiler plugin read it).  The span records are emptied on entry and on
    exit: read `spans()` inside the scope, after synchronising the card."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        clear_spans()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
