"""Device (H100): % of the profiled slice in which no device operation ran.
Moves serve_p95_ms."""

from benchmark.harness import readers


def read(run):
    return readers.idle_share(run)
