"""The traced stretch of a ``--trace 1`` run: the benchmark's own spans
around its calls into each layer, and ``torch.profiler``'s record of the
device, kept in memory.

Every edge of the stretch and of each span is a marker kernel
(``torch.cuda._sleep``, which the program never launches), launched by
the benchmark as the host crosses it. The profiler numbers each launch
with a correlation id, in launch order over every thread, and gives the
same id to the kernel launched. A kernel belongs to the span between
whose two markers it was launched: the backward pass that autograd
launches from its own thread falls in the span of the call that asked
for it. No reading of the host's clock is mixed with the profiler's,
which was seen to drift from it by milliseconds within a stretch.

The stretch runs on the device's clock from the first marker's start to
the last's end. Busy time is the union of the kernels' device intervals;
the rest is idle, and each idle gap is named by the innermost span the
host was in meanwhile (a span lasts from its first marker's launch to
its second's, on the profiler's clock).

A stretch is refused, and another traced, where a marker is missing,
where it is shorter than asked, or where spans of one name launched
different numbers of device operations: the profiler was seen to lose
the events nearest the start or the end of a stretch, and to keep only
a stretch's last call.
"""

import bisect
import contextlib
import dataclasses
import sys
import time

import torch

MARK = "spin_kernel"  # ``torch.cuda._sleep``'s kernel


@dataclasses.dataclass
class Kernel:
    name: str
    start: float  # microseconds from the start of the stretch, on the device
    end: float
    launch: float | None  # microseconds, the launch on the host; None if not found
    corr: int = -1  # the launch's correlation id

    @property
    def us(self):
        return self.end - self.start


@dataclasses.dataclass
class Span:
    name: str
    tag: str  # e.g. the pool block the call took
    start: float  # microseconds from the start of the stretch, on the host
    end: float
    lo: int = -1  # correlation ids of its two markers
    hi: int = -1


class Refused(RuntimeError):
    """A traced stretch that was not recorded whole."""


class Trace:
    """What a traced stretch recorded. Times in microseconds from the
    first marker's start on the device; ``window_us`` is the stretch's
    length on the device."""

    def __init__(self, kernels, spans, window_us):
        self.kernels = kernels
        self.spans = spans
        self.window_us = window_us
        self.busy_intervals = _union([(max(k.start, 0.0), min(k.end, window_us))
                                      for k in kernels if k.end > 0 and k.start < window_us])
        self.busy_us = sum(e - s for s, e in self.busy_intervals)
        self._by_corr = sorted(kernels, key=lambda k: k.corr)
        self._corrs = [k.corr for k in self._by_corr]

    def spans_named(self, name):
        return [s for s in self.spans if s.name == name]

    def _launched(self, span):
        a = bisect.bisect_right(self._corrs, span.lo)
        return self._by_corr[a:bisect.bisect_left(self._corrs, span.hi, a)]

    def kernels_in(self, name):
        """Kernels launched inside a span of ``name``."""
        return [k for s in self.spans_named(name) for k in self._launched(s)]

    def launch_counts(self):
        """{span name: [device operations launched in each span]}."""
        out = {}
        for s in self.spans:
            out.setdefault(s.name, []).append(len(self._launched(s)))
        return out

    def idle_gaps(self):
        """(name of the innermost span the host was in, seconds) of each
        idle gap of the stretch."""
        gaps, t = [], 0.0
        for s, e in self.busy_intervals + [(self.window_us, self.window_us)]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [s for s in self.spans if s.start <= mid <= s.end]
            name = min(inner, key=lambda s: s.end - s.start).name if inner else "harness"
            out.append((name, (b - a) * 1e-6))
        return out

    def breakdown(self, top=10):
        """The device operations that took most time and the idle time by
        what the host was doing: [[name, seconds], ...] each."""
        ops = {}
        for k in self.kernels:
            ops[k.name] = ops.get(k.name, 0.0) + k.us * 1e-6
        idle = {}
        for name, sec in self.idle_gaps():
            idle[name] = idle.get(name, 0.0) + sec
        rank = lambda d: [[n[:160], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}

    @classmethod
    def read(cls, device, marks, seconds):
        """The stretch from the device's operations as recorded
        (:class:`Kernel`, on the profiler's clock) and the markers the
        host launched, in order: ``None`` for the stretch's two edges,
        ``(name, tag)`` for each span's two. Raises :class:`Refused`
        where it was not recorded whole."""
        found = sorted((k for k in device if MARK in k.name), key=lambda k: k.corr)
        if len(found) != len(marks) or any(k.launch is None for k in found):
            raise Refused(f"{len(found)} of the stretch's {len(marks)} markers recorded "
                          "with their launch")
        origin = found[0].start
        window = found[-1].end - origin
        if window < 0.9 * seconds * 1e6:
            raise Refused(f"a stretch of {window * 1e-6} s where {seconds} s were traced")
        kernels = [Kernel(k.name, k.start - origin, k.end - origin,
                          None if k.launch is None else k.launch - origin, k.corr)
                   for k in device if MARK not in k.name]
        spans, open_ = [], {}
        for mark, k in zip(marks[1:-1], found[1:-1]):
            if mark in open_:
                a = open_.pop(mark)
                spans.append(Span(mark[0], mark[1], a.launch - origin, k.launch - origin,
                                  a.corr, k.corr))
            else:
                open_[mark] = k
        trace = cls(kernels, sorted(spans, key=lambda s: s.lo), window)
        counts = {name: (len(n), min(n), max(n)) for name, n in trace.launch_counts().items()}
        print(f"trace: {window * 1e-6:.4f} s, {len(kernels)} device operations, "
              f"{sum(k.launch is None for k in kernels)} without their launch; "
              f"(spans, least and most device operations launched in one): {counts}",
              file=sys.stderr, flush=True)
        if not counts:
            raise Refused("no span recorded")
        for name, (n, least, most) in counts.items():
            if least != most or not most:
                raise Refused(f"{n} {name} spans launched {least} to {most} device operations")
        return trace


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


class Tracer:
    """Spans around the benchmark's calls, and a profiler started for the
    last ``seconds`` of the window. Disabled, it costs a null context.

    The profiler records the device's activity alone (its kernels and the
    runtime calls that launched them): recording every host operation as
    well made the host the bottleneck of the traced stretch (a training
    iteration's 14,000 launches then took longer to launch than to run).

    A process's first profiler run sets up the tracing library, which
    takes seconds and keeps only that run's last events, and a run begun
    within seconds of it lost events too (2 traced stretches of 9 at 8 s;
    none at 20 s or more); once set up, every launch of the process is
    slower, traced or not. So a throwaway profiler run sets it up
    ``SET_UP_S`` before the traced stretch, inside the window; host-clock
    readings take the window before it. The profiler lost one or two of
    a stretch's markers, whatever the stretch's length: so the stretch's
    edges keep ``PAD_S`` and ``PADS`` device operations of the
    benchmark's own from the profiler's start and stop. A stretch that is
    refused is traced again after the window, up to ``TRIES`` in all."""

    SET_UP_S = 20.0
    PAD_S = 0.05
    PADS = 2
    LEAD_S = 0.25
    TRIES = 3

    def __init__(self, enabled, seconds=0.0):
        self.enabled = enabled
        self.seconds = seconds
        self.prof = None
        self.started = None  # host time the tracing library was set up
        self.marks = []
        self.trace = None
        self.refusals = []

    def _mark(self, what):
        torch.cuda._sleep(0)
        self.marks.append(what)

    @contextlib.contextmanager
    def _span(self, name, tag):
        traced = self.prof is not None
        if traced:
            self._mark((name, str(tag)))
        try:
            yield
        finally:
            if traced:
                self._mark((name, str(tag)))

    def span(self, name, tag=""):
        return self._span(name, tag) if self.enabled else contextlib.nullcontext()

    def _profiler(self):
        act = torch.profiler.ProfilerActivity
        return torch.profiler.profile(
            activities=[act.CUDA if torch.cuda.is_available() else act.CPU])

    def _pad(self):
        for _ in range(self.PADS):
            self._scratch.add_(1)
        torch.cuda.synchronize()

    def _start(self):
        self.marks = []
        self._scratch = torch.zeros(1, device="cuda")
        self.prof = self._profiler()
        self.prof.start()
        time.sleep(self.PAD_S)
        self._pad()
        self._mark(None)

    def tick(self, now, window_end):
        """Set the tracing library up ``SET_UP_S`` before the traced
        stretch, and start the profiler once the window has ``seconds``
        left, and ``LEAD_S`` for the profiler's start and the padding."""
        if not self.enabled or self.prof is not None or self.refusals:
            return
        if self.started is None and now >= window_end - self.seconds - self.SET_UP_S:
            self.started = now
            with self._profiler():
                torch.ones(8).sum()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        lead = self.seconds + self.LEAD_S
        if self.started is not None and time.perf_counter() >= window_end - lead:
            self._start()

    def stop(self):
        """Stop the profiler (after the window's closing synchronisation)
        and keep what it recorded as :attr:`trace`, or the reason it was
        refused in :attr:`refusals`."""
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self._mark(None)
        self._pad()
        time.sleep(self.PAD_S)
        prof, self.prof = self.prof, None
        prof.stop()
        try:
            self.trace = from_events(prof.events(), self.marks, self.seconds)
        except Refused as e:
            self.refusals.append(str(e))
            print(f"trace: stretch refused: {e}", file=sys.stderr, flush=True)

    def finish(self, call, sync):
        """End the window's stretch; while the last one was refused, and
        tries are left, trace ``seconds`` more of ``call()`` after it."""
        self.stop()
        while (self.enabled and self.trace is None and self.started is not None
               and len(self.refusals) < self.TRIES):
            self._start()
            end = time.perf_counter() + self.seconds
            while time.perf_counter() < end:
                call()
            sync()
            self.stop()


def from_events(events, marks, seconds):
    """A :class:`Trace` from the profiler's events (see :meth:`Trace.read`)."""
    cpu_t = torch.autograd.DeviceType.CPU
    # with the device's activity alone, the host events are the runtime and
    # launch calls (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...)
    launches = {e.id: e.time_range.start for e in events if e.device_type == cpu_t}
    device = [Kernel(e.name, e.time_range.start, e.time_range.end, launches.get(e.id), e.id)
              for e in events if e.device_type != cpu_t and not e.is_user_annotation]
    return Trace.read(device, marks, seconds)
