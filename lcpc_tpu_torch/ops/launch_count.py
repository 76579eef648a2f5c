"""The kernel wrappers' launch counters, and their bookkeeping under a CUDA graph.

Every wrapper of this package that launches a kernel adds one to its
`.launches` where it launches it, and nowhere else; `counted(obj)` sets that
count to 0 and lists the wrapper in COUNTERS.  A CUDA-graph capture runs the
wrappers once and launches nothing: `captured()` takes back what they counted
inside it and hands it over, and `replayed(counts)` adds it at each replay,
so the counters count the kernels every replay launches.
"""

from __future__ import annotations

import contextlib

COUNTERS: list = []  # every launch counter of the package's kernel wrappers


def counted(obj):
    """obj.launches = 0, and obj listed in COUNTERS; returns obj."""
    obj.launches = 0
    COUNTERS.append(obj)
    return obj


class LaunchCount:
    """One kernel behind a wrapper of several: its launches, counted where
    the wrapper launches it (`launches`)."""

    def __init__(self):
        counted(self)


@contextlib.contextmanager
def captured():
    """Inside: the launches counted are taken back off their counters on the
    way out and put into the dict yielded ({counter: launches})."""
    before = [c.launches for c in COUNTERS]
    counts: dict = {}
    try:
        yield counts
    finally:
        for c, n in zip(COUNTERS, before):
            if c.launches != n:
                counts[c] = c.launches - n
                c.launches = n


def replayed(counts: dict) -> None:
    """Count the launches of a captured graph's replay (counts from captured())."""
    for c, n in counts.items():
        c.launches += n
