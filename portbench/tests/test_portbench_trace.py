"""The reduction of a profiler trace to busy time, kernel time and idle
gaps, on a hand-made timeline."""

import pytest

from portbench.trace import WINDOW, Trace, overlap, union

EVENTS = [(WINDOW, False, True, 0.0, 10.0),
          ("k1", True, False, 1.0, 2.0), ("k2", True, False, 1.5, 2.5),
          ("k3", True, False, 4.0, 5.0), ("k4", True, False, 9.5, 11.0),
          ("mirrored range", True, True, 0.0, 10.0),
          ("outer", False, False, 0.5, 9.0), ("inner", False, False, 2.6, 3.9)]


def test_busy_is_the_union_of_device_operations_in_the_window():
    t = Trace(EVENTS)
    assert t.window_s == 10.0
    assert t.busy_s == pytest.approx(1.5 + 1.0 + 0.5)       # k1 and k2 overlap; k4 cut
    assert t.kernel_s(["k1", "k2"]) == pytest.approx(2.0)
    assert [n for n, _ in t.device_ops()] == ["k1", "k2", "k3", "k4"]


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    gaps = dict(Trace(EVENTS).idle_gaps())
    assert gaps["inner"] == pytest.approx(1.5)                # (2.5, 4.0), middle 3.25
    assert gaps["outer"] == pytest.approx(1.0 + 4.5)          # (0, 1) and (5, 9.5)
    assert sum(gaps.values()) == pytest.approx(10.0 - 3.0)


def test_union_and_overlap():
    a = union([(0, 2), (1, 3), (5, 6)])
    assert a.tolist() == [[0, 3], [5, 6]]
    assert overlap(a, union([(2, 5.5)])) == pytest.approx(1.5)


def test_a_trace_needs_its_window():
    with pytest.raises(ValueError):
        Trace(EVENTS[1:])
