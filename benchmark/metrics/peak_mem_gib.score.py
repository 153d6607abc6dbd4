"""Device (H100): max_memory_allocated over the window, GiB. Moves
score_rows_per_s."""

from benchmark.harness import readers


def read(run):
    return readers.peak_gib(run)
