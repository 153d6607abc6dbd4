"""Device (H100): max_memory_allocated over the window, GiB. Moves
serve_p95_ms."""

from benchmark.harness import readers


def read(run):
    return readers.peak_gib(run)
