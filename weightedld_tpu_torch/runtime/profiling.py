"""The port's tracer: per-stage wall-clock timing, spans and device traces.

``StageTimer`` is a copy of ``weightedld_tpu/runtime/profiling.py:19-39``
(the reference's per-stage spans, ``main.rs:128-210``), and
``device_trace`` a counterpart of its ``:43-51`` on ``torch.profiler`` in
place of ``jax.profiler``.  A stage that launches CUDA work must
synchronize before it ends for its span to cover the device time; the
driver's stages do (they end in a host copy).

:func:`span` is the tracer below both.  It records exactly while a
``torch.profiler`` session records this process (``--profile-dir``, or any
profiler a caller runs): a span then also opens the profiler range
``wld.<name>``, so the program's ranges land in the same trace as the
kernels, on its clock, nested inside the caller's ranges.  Otherwise a
span is one flag check that returns a shared null context: no range, no
CUDA event, nothing stored.

A finished span (:class:`Span`) holds its name and id, its parent (the
innermost span open on the thread when it began) and its root, its start
and end on ``time.monotonic()`` (the clock of ``StageTimer``), its
attributes (the counts of the work it covers) and, where it was asked for
on a CUDA device, the device time between an event recorded on the
current stream at entry and one at exit.  Spans are kept in a bounded
list in this module, the oldest dropped first and counted
(:func:`dropped`), and read with :func:`spans`, which resolves the device
times with one synchronize per device: nothing on the hot path waits for
the device.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

log = logging.getLogger("weightedld_tpu_torch")

# Finished spans kept: a 20 s window of session queries makes ~15,000.
MAX_SPANS = 1 << 17

_profiler_on = torch._C._autograd._profiler_enabled
_done: collections.deque = collections.deque(maxlen=MAX_SPANS)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _open_spans() -> list:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


class _Null:
    """The span of a process that no profiler records: enters (as itself),
    exits (letting an exception through), is false and takes attributes,
    and does nothing.  Its methods are C callables, so that a span off
    costs no Python frame: ``"".format`` takes any arguments and returns
    the empty string, which is false."""

    __slots__ = ()
    __exit__ = staticmethod("".format)
    __bool__ = staticmethod(bool)
    set = staticmethod("".format)


_NULL = _Null()
_Null.__enter__ = staticmethod(itertools.repeat(_NULL).__next__)


class Span:
    """One traced extent of the program (see the module docstring).
    ``device_s`` is None until :func:`spans` resolves it, and stays None
    for a span without device events (the CPU, or not asked for)."""

    __slots__ = ("name", "id", "parent_id", "root_id", "root_name", "start",
                 "end", "attrs", "device_s", "_device", "_events", "_range")

    def __init__(self, name: str, device, attrs: dict):
        stack = _open_spans()
        parent = stack[-1] if stack else None
        self.name = name
        self.id = next(_ids)
        self.parent_id = parent.id if parent is not None else None
        self.root_id = parent.root_id if parent is not None else self.id
        self.root_name = parent.root_name if parent is not None else name
        self.start = self.end = None
        self.attrs = attrs
        self.device_s = None
        self._device = _cuda_device(device)
        self._events = self._range = None

    def __bool__(self):
        return True

    def set(self, **attrs) -> None:
        """Add attributes (counts known only once the work is done)."""
        self.attrs.update(attrs)

    def __enter__(self):
        _open_spans().append(self)
        self._range = record_function("wld." + self.name)
        self._range.__enter__()
        if self._device is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self._device))
        self.start = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end = time.monotonic()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        self._range.__exit__(exc_type, exc, tb)
        self._range = None
        stack = _open_spans()
        # By identity: a generator's span may close after spans opened
        # while it was suspended.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        global _dropped
        with _lock:
            if len(_done) == _done.maxlen:
                _dropped += 1
            _done.append(self)
        return None


def _cuda_device(device) -> torch.device | None:
    """The CUDA device whose stream a span's events go on: ``True`` is the
    current one; a ``torch.device`` (or its name) of another type gets
    none."""
    if device is False or device is None:
        return None
    if device is True:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.type == "cuda" else None


def span(name: str, device=False, **attrs):
    """A context manager over one extent of the program named ``name``,
    with ``attrs`` (set more with ``.set(**attrs)`` inside it).
    ``device=True`` (or the CUDA device the work runs on) adds the device
    time between its entry and exit on that device's current stream.
    While no profiler records, the shared null context, which is falsy:
    guard attribute work with ``if sp:``."""
    if not _profiler_on():
        return _NULL
    return Span(name, device, attrs)


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost span open on this thread, if any."""
    if not _profiler_on():
        return
    stack = _open_spans()
    if stack:
        stack[-1].attrs.update(attrs)


def spanned(name: str):
    """Decorate a function, or a generator function, with :func:`span`
    ``name``: a generator's span runs from its first item to its
    exhaustion or close."""
    def wrap(fn):
        if inspect.isgeneratorfunction(fn):
            @functools.wraps(fn)
            def gen(*args, **kwargs):
                with span(name):
                    yield from fn(*args, **kwargs)
            return gen

        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans() -> list[Span]:
    """The finished spans, oldest first, their device times resolved (one
    synchronize per device that has spans still unresolved)."""
    with _lock:
        done = list(_done)
    pending = [s for s in done if s._events is not None]
    for dev in {s._device for s in pending}:
        torch.cuda.synchronize(dev)
    for s in pending:
        s.device_s = s._events[0].elapsed_time(s._events[1]) * 1e-3
        s._events = None
    return done


def dropped() -> int:
    """Finished spans dropped from the bounded list, oldest first."""
    return _dropped


@dataclass
class StageTimer:
    spans: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block as stage ``name`` (summed over repeats), inside
        the span ``stage.<name>``."""
        t0 = time.monotonic()
        try:
            with span("stage." + name):
                yield
        finally:
            dt = time.monotonic() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            log.info("stage %-20s %8.3fs", name, dt)

    def report(self) -> str:
        total = sum(self.spans.values())
        denom = total or 1.0
        lines = [f"{k:<20} {v:8.3f}s ({v / denom:5.1%})"
                 for k, v in self.spans.items()]
        lines.append(f"{'total':<20} {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | os.PathLike | None, device=None):
    """Record a ``torch.profiler`` trace of the block into ``log_dir`` (a
    no-op without one): CUDA and CPU activity when ``device`` is a CUDA
    device, CPU activity otherwise, written as one Chrome trace file
    ``trace_<ms since epoch>_<pid>.json`` (load it in Perfetto or
    ``chrome://tracing``).  The program's spans inside the block appear in
    it as ``wld.<name>`` ranges."""
    if not log_dir:
        yield
        return
    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{int(time.time() * 1000)}_"
                        f"{os.getpid()}.json")
    prof.export_chrome_trace(path)
    log.info("device trace written to %s", path)
