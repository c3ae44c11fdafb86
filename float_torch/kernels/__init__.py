"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``).

Nothing here builds or imports CUDA code at import time: each wrapper
builds its library at its first launch (``build.load``).  ``LAUNCHES``
counts kernel launches by kernel name; a wrapper adds one exactly where
it launches, so a run can show that its main path went through the
kernels.  ``LAUNCH_SHAPES`` counts the same launches by (name, B, H, W, C),
so a run can also show which shapes its path gave each kernel.

Both count the launches that reach the card.  A launch captured into a
CUDA graph reaches it once per replay, so it counts once per replay and
not at its capture (``CapturedLaunches``).
"""
from collections import Counter

LAUNCHES: Counter = Counter()
LAUNCH_SHAPES: Counter = Counter()


class CapturedLaunches:
    """The launches the wrappers counted while a CUDA graph was captured
    within this context: taken back out of ``LAUNCHES`` and
    ``LAUNCH_SHAPES`` when it closes, since a capture runs nothing on the
    card, and added again by each ``replay``."""

    def __enter__(self):
        self._before = Counter(LAUNCHES), Counter(LAUNCH_SHAPES)
        return self

    def __exit__(self, *exc):
        self.launches = Counter(LAUNCHES) - self._before[0]
        self.shapes = Counter(LAUNCH_SHAPES) - self._before[1]
        for counts, delta in ((LAUNCHES, self.launches),
                              (LAUNCH_SHAPES, self.shapes)):
            counts.subtract(delta)
            for k in delta:
                if counts[k] <= 0:
                    del counts[k]
        return False

    def replay(self, graph) -> None:
        """``graph.replay()``, counting the launches it makes."""
        graph.replay()
        LAUNCHES.update(self.launches)
        LAUNCH_SHAPES.update(self.shapes)
