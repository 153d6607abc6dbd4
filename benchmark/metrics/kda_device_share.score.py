"""Model step (the KDA core): % of the profiled slice's busy device time in
operations named kda_ (csrc/kda.cu: the convolution, the chunked delta rule's
two launches, the gated output norm). Lower is better: a faster core lowers
it. Moves score_rows_per_s."""

from benchmark.harness import trace


def read(run):
    s = run.summary
    seconds = trace.kernel_seconds(s, "kda_")
    if not s or s["busy_s"] <= 0 or seconds <= 0:
        return None
    return 100.0 * seconds / s["busy_s"]
