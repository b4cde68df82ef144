"""The window's arithmetic: a rate over the whole window, a tail over
every call."""

from benchmark.window import Call, Window, percentile


def _window(latencies, gap=0.0):
    calls, t = [], 0.0
    for lat in latencies:
        calls.append(Call(t, t, t + lat, {"vis": 100}))
        t += lat + gap
    return Window(0.0, t, calls)


def test_rate_is_over_the_whole_window():
    w = _window([0.01] * 100)
    assert abs(w.rate("vis") - 100 * 100 / 1.0) < 1e-6
    # idle time between calls counts in the window's length
    w = _window([0.01] * 100, gap=0.01)
    assert abs(w.rate("vis") - 100 * 100 / 2.0) < 1e-6


def test_p95_is_over_every_call():
    lat = [0.010] * 94 + [0.020] * 6
    assert percentile(lat, 95) == 0.020
    assert percentile([0.010] * 95 + [0.020] * 5, 95) == 0.010
    assert percentile([3.0], 95) == 3.0


def test_a_stall_moves_rate_and_tail():
    steady = _window([0.01] * 200)
    stalled = _window([0.01] * 189 + [0.5] * 11)
    assert stalled.rate("vis") < 0.5 * steady.rate("vis")
    assert abs(percentile(stalled.latencies(), 95) - 0.5) < 1e-9
    assert abs(percentile(steady.latencies(), 95) - 0.01) < 1e-9


def test_before_cuts_at_the_trace():
    w = _window([0.01] * 10)
    cut = w.before(0.05)
    assert cut.seconds == 0.05 and len(cut.calls) == 5
    assert w.before(None) is w
