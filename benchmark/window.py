"""The measured window: what each call did and when, and the arithmetic
the end-to-end metrics take from it.

A rate is the work of every call in the window over the window's whole
length, from its start to the synchronisation that closes it; a tail is
taken over every call's latency. Neither leaves a call out.
"""

import dataclasses
import math
import statistics


@dataclasses.dataclass
class Call:
    """One call of the window: host seconds when it was entered, when it
    returned (before any wait for the card), and when its result was
    ready; the work it did, by kind; and anything else its loop keeps."""

    start: float
    returned: float
    ready: float
    work: dict
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def latency(self):
        return self.ready - self.start


@dataclasses.dataclass
class Window:
    """The calls made between ``start`` and ``close`` (host seconds)."""

    start: float
    close: float
    calls: list

    @property
    def seconds(self):
        return self.close - self.start

    def rate(self, kind):
        """Work of ``kind`` a second, over the whole window."""
        return sum(c.work.get(kind, 0) for c in self.calls) / self.seconds

    def latencies(self):
        return [c.latency for c in self.calls]

    def before(self, t):
        """The window cut at host time ``t``: the calls done by then."""
        if t is None or t >= self.close:
            return self
        return Window(self.start, t, [c for c in self.calls if c.ready <= t])


def percentile(values, q):
    """The ``q``-th percentile (0-100) by nearest rank: the smallest value
    with at least ``q`` percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100 * len(ordered)), 1) - 1]


def median(values):
    return statistics.median(values)
