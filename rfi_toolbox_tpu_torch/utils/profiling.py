"""Profiling and tracing hooks.

Counterpart of ``rfi_toolbox_tpu/utils/profiling.py``:

- :func:`trace`: context manager around ``torch.profiler`` (CPU, and
  CUDA activity when a card is present) writing a Chrome trace
  (``chrome://tracing``, Perfetto) into a directory; the program's spans
  appear in it by name;
- :class:`StepTimer`: wall-clock step timing with device sync, running
  statistics and throughput;
- :func:`annotate`: a named ``record_function`` scope, so that pipeline
  stages show up in the profiler's timeline;
- :func:`span` and :func:`recording` (the port's own): the program's
  spans around the steps of its calls, and the recorder that keeps them.

The program's spans (dotted names; a span never encloses another of its
name):

- ``flag.call`` (a ``flag_waterfalls`` call) > ``flag.patchify``,
  ``flag.mad`` (K5), ``flag.extract`` (K4), ``flag.predict`` (the
  predictor), ``flag.unpatchify``;
- ``coherent.call`` (a ``flag_waterfalls_coherent`` call) >
  ``coherent.images`` (``coherent_images``: patchify, ``to_8ch`` and the
  robust scale) > ``coherent.scale`` (the robust scale alone);
  ``coherent.call`` > ``coherent.predict`` (the predictor),
  ``coherent.unpatchify``;
- ``predict`` (a ``CompiledPredictor`` call) > ``predict.logits`` (the
  model's forward on one batch);
- ``prep.base``, ``prep.select``, ``prep.extract`` (static prep: base
  patches and flags, the selection, labels and images by K1 and K3);
- ``train.step`` > ``train.forward`` (logits and loss),
  ``train.backward`` (gradients, summed over the group on a mesh),
  ``train.optimizer`` (clip and AdamW); a step that replays
  ``train_steps``' CUDA graph: ``train.step`` > ``train.replay`` (the
  inputs' copies and the graph of the forward and backward),
  ``train.optimizer``;
- ``ms.load``, ``ms.to_card``, ``ms.card``, ``ms.to_host``, ``ms.save``
  (the stages of ``flag_measurement_set``; its ``timings=``).

Spans are opened on the thread that launches the call's work: the
backward pass that autograd runs on its own thread falls inside
``train.backward``. With no recorder installed a span is one shared
null context: it allocates nothing and touches no device.

>>> with recording() as rec:
...     flag_waterfalls(wf)
>>> [(s.name, s.tag) for s in rec.spans]
[('flag.call', '0'), ('flag.patchify', '0'), ...]
"""

import contextlib
import dataclasses
import itertools
import threading
import time
from pathlib import Path

import torch

__all__ = ["trace", "annotate", "StepTimer", "span", "recording"]


@contextlib.contextmanager
def trace(logdir):
    """Capture a trace of the enclosed code into
    ``logdir/trace_<ns>.json`` (a Chrome trace). The program's spans are
    ``record_function`` ranges in it, named as the spans are: it installs
    the span recorder, so it is not entered inside :func:`recording`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with recording(on_edge=_ranges()):
            yield
    prof.export_chrome_trace(str(logdir / f"trace_{time.time_ns()}.json"))


def _ranges():
    """An ``on_edge`` that opens a ``record_function`` range at a span's
    first edge and closes it at its second."""
    open_ = {}

    def on_edge(name, tag):
        rf = open_.pop((name, tag), None)
        if rf is None:
            open_[name, tag] = rf = torch.profiler.record_function(name)
            rf.__enter__()
        else:
            rf.__exit__(None, None, None)

    return on_edge


def annotate(name):
    """Named scope appearing in profiler timelines."""
    return torch.profiler.record_function(name)


@dataclasses.dataclass(eq=False, slots=True)
class SpanRecord:
    """One recorded span: host times from ``time.perf_counter_ns``
    (``end`` None while it is open)."""

    name: str
    tag: str  # the request's identifier: the root span's, inherited by its children
    start: int
    end: int | None = None

    @property
    def seconds(self):
        return (self.end - self.start) * 1e-9


class Recorder:
    """The spans recorded while it was installed, in the order they
    opened (:attr:`spans`). ``on_edge(name, tag)``, when given, is called
    on the span's thread at each of its two edges: before its body runs
    and after it (an exception leaving the body included)."""

    def __init__(self, on_edge=None):
        self.on_edge = on_edge
        self.spans = []


_recorder = None  # the installed recorder; None: spans are off
_install = threading.Lock()
_open = threading.local()  # .stack: this thread's open spans, innermost last
_roots = itertools.count()  # tags of root spans, per process


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return None


_NULL = _Null()


class _Span:
    __slots__ = ("name", "recorder", "record")

    def __init__(self, name, recorder):
        self.name, self.recorder = name, recorder

    def __enter__(self):
        try:
            stack = _open.stack
        except AttributeError:
            stack = _open.stack = []
        tag = stack[-1].tag if stack else str(next(_roots))
        on_edge = self.recorder.on_edge
        if on_edge is not None:
            on_edge(self.name, tag)
        self.record = record = SpanRecord(self.name, tag, time.perf_counter_ns())
        stack.append(record)
        self.recorder.spans.append(record)
        return record

    def __exit__(self, kind, value, tb):
        record = self.record
        record.end = time.perf_counter_ns()
        _open.stack.pop()
        on_edge = self.recorder.on_edge
        if on_edge is not None:
            on_edge(record.name, record.tag)
        return None


def span(name):
    """The program's span ``name`` around the enclosed code. Off (no
    recorder installed) it is a shared null context. On, it records its
    name, its tag (its enclosing span's, else a new per-process number)
    and its host start and end in the recorder. The enclosed code runs as
    it does off."""
    if _recorder is None:
        return _NULL
    return _Span(name, _recorder)


@contextlib.contextmanager
def recording(on_edge=None):
    """Install a :class:`Recorder` for the block and yield it; its spans
    stay readable after the block. Spans are recorded from every thread
    while it is installed. One recorder is installed at a time: entering
    a second one, from any thread, raises ``RuntimeError``."""
    global _recorder
    rec = Recorder(on_edge)
    with _install:
        if _recorder is not None:
            raise RuntimeError("a span recorder is already installed")
        _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None


class StepTimer:
    """Wall-clock step timing with optional device synchronization.

    >>> timer = StepTimer(sync=True)
    >>> for batch in data:
    ...     with timer.step(items=len(batch)):
    ...         loss = train_step(*batch)
    >>> timer.summary()
    {'steps': N, 'mean_ms': ..., 'p50_ms': ..., 'items_per_sec': ...}
    """

    def __init__(self, sync=True, skip_first=1):
        self.sync = sync
        self.skip_first = skip_first
        self.times = []
        self.items = []

    @contextlib.contextmanager
    def step(self, items=1, result=None):
        """Time the enclosed block. With ``sync`` the card's queued work is
        waited for (``torch.cuda.synchronize``) before the clock stops, so
        that the time covers execution, not just the launches. ``result``
        is accepted for the JAX signature: the sync waits for all work."""
        del result
        t0 = time.perf_counter()
        yield
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        self.items.append(items)

    def summary(self):
        times = self.times[self.skip_first:] or self.times
        items = self.items[self.skip_first:] or self.items
        if not times:
            return {"steps": 0}
        times_sorted = sorted(times)
        total = sum(times)
        return {
            "steps": len(times),
            "mean_ms": 1000 * total / len(times),
            "p50_ms": 1000 * times_sorted[len(times) // 2],
            "max_ms": 1000 * times_sorted[-1],
            "items_per_sec": sum(items) / total if total > 0 else 0.0,
        }

    def reset(self):
        self.times.clear()
        self.items.clear()
