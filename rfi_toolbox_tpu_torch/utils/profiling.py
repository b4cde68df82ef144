"""Profiling and tracing hooks.

Counterpart of ``rfi_toolbox_tpu/utils/profiling.py``:

- :func:`trace`: context manager around ``torch.profiler`` (CPU, and
  CUDA activity when a card is present) writing a Chrome trace
  (``chrome://tracing``, Perfetto) into a directory;
- :class:`StepTimer`: wall-clock step timing with device sync, running
  statistics and throughput;
- :func:`annotate`: a named ``record_function`` scope, so that pipeline
  stages show up in the profiler's timeline.
"""

import contextlib
import time
from pathlib import Path

import torch

__all__ = ["trace", "annotate", "StepTimer"]


@contextlib.contextmanager
def trace(logdir):
    """Capture a trace of the enclosed code into
    ``logdir/trace_<ns>.json`` (a Chrome trace)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(logdir / f"trace_{time.time_ns()}.json"))


def annotate(name):
    """Named scope appearing in profiler timelines."""
    return torch.profiler.record_function(name)


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
