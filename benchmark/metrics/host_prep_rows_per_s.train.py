"""Host input: rows a second of one epoch through training/loop.host_batches
alone, same workers, no device. Moves train_samples_per_s."""

from benchmark.harness import readers


def read(run):
    return readers.measured(run, "host_prep_rows_per_s")
