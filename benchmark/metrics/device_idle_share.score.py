"""Device (H100): % of the profiled slice in which no device operation ran.
Moves score_rows_per_s."""

from benchmark.harness import readers


def read(run):
    return readers.idle_share(run)
