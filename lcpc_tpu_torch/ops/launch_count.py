"""The kernel wrappers' launch counters.

Every wrapper of this package that launches a kernel adds one to its
`.launches` where it launches it, and nowhere else; `counted(obj)` sets that
count to 0 and lists the wrapper in COUNTERS.
"""

from __future__ import annotations

COUNTERS: list = []  # every launch counter of the package's kernel wrappers


def counted(obj):
    """obj.launches = 0, and obj listed in COUNTERS; returns obj."""
    obj.launches = 0
    COUNTERS.append(obj)
    return obj


class LaunchCount:
    """One kernel behind a wrapper of several: its launches, counted where
    the wrapper launches it (`launches`); `__name__` names it where given."""

    def __init__(self, name: "str | None" = None):
        if name is not None:
            self.__name__ = name
        counted(self)
