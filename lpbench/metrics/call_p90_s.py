"""The 90th percentile (nearest rank) of the call walls over every call
of the window: what a caller waiting on a sweep feels."""

from ..harness import percentile


def read(run):
    return percentile(run.walls, 90.0)
