"""Host input (data/dataset.CSVDataset, data/cache.PixelCache, the tokenizer):
rows a second of one pass of the scoring prep alone, same workers, no
device. Moves score_rows_per_s."""

from benchmark.harness import readers


def read(run):
    return readers.measured(run, "host_prep_rows_per_s")
