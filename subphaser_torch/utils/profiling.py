"""Spans of a job (host seconds, device seconds, calls, the card's memory
high-water mark) and an optional torch.profiler trace of a whole run.

``Spans`` records the spans of one job. ``Pipeline.run`` makes its recorder
current (``Spans.job``) on the thread that runs the job; there
``span(name)`` opens a span nested in the open one, whose path is its
ancestors' names and its own joined by ``/`` (``count/runs``). Elsewhere,
outside a job or on another thread, ``span`` does nothing. On exit a span
adds its host seconds (``time.perf_counter``) to ``seconds[path]``, counts
the call, and, while a profiler records, puts a zero-length mark named
``subphaser step <path> <seconds>`` into the trace at its end, so a reader
finds its window, [end - seconds, end], on the trace's own clock; an inner
span's mark ends before its parent's. With ``device=True`` on CUDA it also
records a pair of timing events on the job device's current stream; the
job's end synchronizes once and adds the stream seconds between each pair
to ``seconds[path + "@device"]``. On CUDA each span reads the allocator's
high-water mark (``torch.cuda.max_memory_allocated``; never reset here) at
both ends, and the innermost span that raised it is kept with its bytes.
``count_launch(entry)`` adds one launch of a kernel's C entry to the
current job's ``launches``, and ``count(name, n)`` adds ``n`` to the open
span's counter ``seconds[path + "@" + name]`` (both no-ops where ``span`` is
one). The job's end logs one ``[perf]`` line of every path's calls, host
and device seconds, that span, the counters and the launches by entry.

``trace(logdir)`` records the host's operators and the card's kernels
(CPU and, where CUDA is available, CUDA activities) and writes one Chrome
trace, ``*.pt.trace.json`` (TensorBoard's profile plugin reads it), into
``logdir``.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time

import torch

from subphaser_torch.utils.log import logger

STEP_MARK = "subphaser step"
DEVICE_SUFFIX = "@device"

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("subphaser_spans", default=None)
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "name", "device", "top", "path", "t0", "peak0", "ev0")

    def __init__(self, rec: "Spans", name: str, device: bool, top: bool = False):
        self.rec, self.name, self.device, self.top = rec, name, device, top

    def __enter__(self):
        rec = self.rec
        stack = rec._stack
        self.path = f"{stack[-1]}/{self.name}" if stack and not self.top else self.name
        stack.append(self.path)
        self.peak0 = self.ev0 = None
        cuda = rec._cuda
        if cuda is not None:
            self.peak0 = _peak_bytes(cuda)
            if self.device:
                self.ev0 = torch.cuda.Event(enable_timing=True)
                self.ev0.record(torch.cuda.current_stream(cuda))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        seconds = time.perf_counter() - self.t0
        rec = self.rec
        rec._stack.pop()
        if exc_type is not None:  # a span that raised is not recorded
            return False
        path = self.path
        _mark(path, seconds)  # first, so that its window matches the span's
        rec.seconds[path] = rec.seconds.get(path, 0.0) + seconds
        rec.calls[path] = rec.calls.get(path, 0) + 1
        cuda = rec._cuda
        if cuda is not None:
            if self.ev0 is not None:
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record(torch.cuda.current_stream(cuda))
                rec._events.append((path, self.ev0, ev1))
            peak = _peak_bytes(cuda)
            if peak > self.peak0 and peak > rec.peak_bytes:
                rec.peak_path, rec.peak_bytes = path, peak
        return False


def _peak_bytes(cuda) -> int:
    """``torch.cuda.max_memory_allocated(cuda)`` without flattening every
    other statistic (a tenth of its cost)."""
    stats = torch.cuda.memory_stats_as_nested_dict(cuda)
    return stats.get("allocated_bytes", {}).get("all", {}).get("peak", 0)


def _mark(path: str, seconds: float) -> None:
    """A zero-length span named ``subphaser step <path> <seconds>`` where a
    profiler records."""
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(f"{STEP_MARK} {path} {seconds!r}"):
            pass


class Spans:
    """The spans of one job: ``seconds`` (host seconds by path, stream
    seconds by ``path@device`` and counters by ``path@<name>``), ``calls``
    by path, ``peak_path`` /
    ``peak_bytes``, the innermost span that last raised the card's memory
    high-water mark, and ``launches``, kernel launches by C entry."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.launches: dict[str, int] = {}
        self.peak_path: str | None = None
        self.peak_bytes = 0
        self._stack: list[str] = []
        self._events: list = []
        self._cuda = None
        self._owner: int | None = None

    def span(self, name: str, device: bool = False, top: bool = False) -> _Span:
        """A span of this recorder, on the thread that runs its job; with
        ``top`` its path is ``name`` alone, a step timed inside another."""
        return _Span(self, name, device, top)

    @contextlib.contextmanager
    def job(self, device):
        """Makes this recorder current on this thread for the block; at its
        end resolves the device spans and logs the ``[perf]`` line."""
        self._cuda = device if getattr(device, "type", None) == "cuda" else None
        self._owner = threading.get_ident()
        token = _CURRENT.set(self)
        try:
            yield self
        except BaseException:
            self._events.clear()
            raise
        else:
            self._resolve()
            self.log()
        finally:
            _CURRENT.reset(token)
            self._owner = None
            self._cuda = None

    def _resolve(self) -> None:
        if not self._events:
            return
        torch.cuda.synchronize(self._cuda)
        for path, ev0, ev1 in self._events:
            key = path + DEVICE_SUFFIX
            self.seconds[key] = self.seconds.get(key, 0.0) + ev0.elapsed_time(ev1) / 1e3
        self._events.clear()

    def log(self) -> None:
        def one(path):
            dev = self.seconds.get(path + DEVICE_SUFFIX)
            host = f"{path} {self.calls[path]} {self.seconds[path]:.3f}"
            return host if dev is None else f"{host} {dev:.3f}"

        peak = (f"; peak {self.peak_bytes} B in {self.peak_path}"
                if self.peak_path is not None else "")
        counters = "".join(f"; counter {key} {n}" for key, n in sorted(self.seconds.items())
                           if "@" in key and not key.endswith(DEVICE_SUFFIX))
        launches = "".join(f"; launches {e} {n}" for e, n in sorted(self.launches.items()))
        logger.info("[perf] spans (path calls host_s [device_s]): %s%s%s%s",
                    "; ".join(one(p) for p in sorted(self.calls)), peak, counters, launches)


def _current() -> Spans | None:
    """The current job's recorder on this thread, or None."""
    rec = _CURRENT.get()
    if rec is None or rec._owner != threading.get_ident():
        return None
    return rec


def span(name: str, device: bool = False):
    """A span of the current job's recorder; a no-op outside a job and on
    any thread but the job's."""
    rec = _current()
    return _NOOP if rec is None else _Span(rec, name, device)


def count_launch(entry: str) -> None:
    """One launch of the C entry ``entry`` in the current job's
    ``launches``; a no-op outside a job and on any thread but the job's."""
    rec = _current()
    if rec is not None:
        rec.launches[entry] = rec.launches.get(entry, 0) + 1


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` of the current job's open span,
    ``seconds[path + "@" + name]``; a no-op outside a span of a job and on
    any thread but the job's."""
    rec = _current()
    if rec is not None and rec._stack:
        key = f"{rec._stack[-1]}@{name}"
        rec.seconds[key] = rec.seconds.get(key, 0) + n


@contextlib.contextmanager
def trace(logdir: str | None):
    """A torch.profiler trace of the block into ``logdir`` when one is
    given, else a no-op."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
    logger.info("[perf] device trace written to %s", logdir)
