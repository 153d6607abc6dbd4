"""Serving (serving/handler.predict_fn): mean host ms inside predict_fn a
request. Moves serve_p95_ms."""

from benchmark.harness import readers


def read(run):
    return readers.measured(run, "predict_ms")
