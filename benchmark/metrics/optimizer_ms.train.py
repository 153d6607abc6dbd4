"""Trainer (training/optim.AdamW): mean device ms of AdamW.step a micro-step,
CUDA events around each call. Moves train_samples_per_s."""

from benchmark.harness import readers


def read(run):
    return readers.measured(run, "optimizer_ms")
