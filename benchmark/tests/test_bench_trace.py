"""The traced window's reduction: busy time as the union of the card's
operations, and the host's samples counted as idle only outside them."""
import _paths  # noqa: F401
from harness import trace


class _Fake(trace.Window):
    def __init__(self, events, samples, t0, t1):
        super().__init__()
        self._events = events
        self.sampler.samples = samples
        self.t0, self.t1 = t0, t1

    def device_events(self):
        return self._events


def test_busy_is_the_union_and_idle_skips_busy_samples():
    s = 1_000_000_000
    w = _Fake([(0, 2 * s, "k1"), (s, 3 * s, "k2"), (5 * s, 6 * s, "k1")],
              [(int(2.5 * s), 0.5, ("main|a:b",)),
               (4 * s, 1.5, ("main|a:b", "w|c:d")),
               (int(5.5 * s), 0.5, ("w|c:d",)),
               (7 * s, 1.0, ("w|c:d",))], 0, 10 * s)
    got = w.summary()
    assert got["busy_s"] == 4.0
    assert got["window_s"] == 10.0
    assert got["device_ops"] == [["k1", 3.0], ["k2", 2.0]]
    assert dict(got["idle_gaps"]) == {"w|c:d": 2.5, "main|a:b": 1.5}


def test_label_names_the_innermost_program_frame():
    import sys
    frame = sys._getframe()
    assert trace._label(frame) is None       # a test, not the program
