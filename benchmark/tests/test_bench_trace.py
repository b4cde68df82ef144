"""The trace's arithmetic: kernels belong to the span between whose
markers they were launched, busy time is the union of kernel intervals,
idle gaps are named by the innermost span the host was in; a stretch is
read between its markers and refused where it was not recorded whole."""

import pytest

from benchmark.trace import Kernel, Refused, Span, Trace


def _trace():
    spans = [Span("flag_waterfalls", "0", 0.0, 100.0, 10, 20),
             Span("predictor", "", 10.0, 60.0, 12, 18),
             Span("flag_waterfalls", "1", 200.0, 300.0, 30, 40)]
    kernels = [Kernel("k4", 20.0, 40.0, 5.0, 11), Kernel("conv", 40.0, 150.0, 20.0, 13),
               Kernel("conv", 140.0, 160.0, 50.0, 15), Kernel("copy", 250.0, 260.0, 210.0, 31),
               Kernel("lost", 270.0, 280.0, None, 50)]
    return Trace(kernels, spans, 400.0)


def test_kernels_follow_their_launch():
    t = _trace()
    assert [k.name for k in t.kernels_in("predictor")] == ["conv", "conv"]
    assert len(t.kernels_in("flag_waterfalls")) == 4
    assert len(t.spans_named("flag_waterfalls")) == 2
    assert t.launch_counts() == {"flag_waterfalls": [3, 1], "predictor": [2]}


def test_busy_is_a_union_and_gaps_are_named():
    t = _trace()
    assert t.busy_us == (160 - 20) + 10 + 10
    # gaps 0-20 (midpoint in the predictor's span), 160-250 and 260-270
    # (in a flag_waterfalls span), 280-400 (in none)
    got = [(name, round(sec * 1e6, 6)) for name, sec in t.idle_gaps()]
    assert got == [("predictor", 20.0), ("flag_waterfalls", 90.0), ("flag_waterfalls", 10.0),
                   ("harness", 120.0)]
    assert abs(dict(t.breakdown()["idle_gaps"])["flag_waterfalls"] - 100e-6) < 1e-12


MARK = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def _recorded(drop=None, length=2.0e6):
    """Device operations as the profiler records them (launches on its
    clock, correlation ids in launch order): the stretch's two markers,
    and two calls, each a span with two markers and two kernels."""
    device = [Kernel(MARK, 1010.0, 1011.0, 1000.0, 1),
              Kernel(MARK, 1100.0, 1100.5, 1050.0, 2), Kernel("k", 1200.0, 1300.0, 1100.0, 3),
              Kernel("k", 1300.0, 1400.0, 1150.0, 4), Kernel(MARK, 1400.0, 1400.5, 1190.0, 5),
              Kernel(MARK, 1500.0, 1500.5, 1450.0, 6), Kernel("k", 1600.0, 1700.0, 1500.0, 7),
              Kernel("k", 1700.0, 1800.0, 1550.0, 8), Kernel(MARK, 1800.0, 1800.5, 1590.0, 9),
              Kernel(MARK, 1000.0 + length, 1001.0 + length, 990.0 + length, 10)]
    if drop is not None:
        del device[drop]
    marks = [None, ("call", "0"), ("call", "0"), ("call", "1"), ("call", "1"), None]
    return device, marks


def test_a_stretch_is_read_between_its_markers():
    t = Trace.read(*_recorded(), seconds=2.0)
    assert t.window_us == 2.0e6 + 1.0 - 10.0
    assert [k.name for k in t.kernels] == ["k"] * 4
    assert [(s.tag, s.start, s.end) for s in t.spans] == [("0", 40.0, 180.0),
                                                          ("1", 440.0, 580.0)]
    assert t.launch_counts() == {"call": [2, 2]}
    assert len(t.kernels_in("call")) == 4
    assert t.busy_us == 400.0


@pytest.mark.parametrize("drop, why", [(0, "markers"), (9, "markers"), (4, "markers"),
                                       (7, "launched 1 to 2")])
def test_a_stretch_not_recorded_whole_is_refused(drop, why):
    with pytest.raises(Refused, match=why):
        Trace.read(*_recorded(drop), seconds=2.0)


def test_a_truncated_stretch_is_refused():
    with pytest.raises(Refused, match="stretch of"):
        Trace.read(*_recorded(length=1.0e6), seconds=2.0)
