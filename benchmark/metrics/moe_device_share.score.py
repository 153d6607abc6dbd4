"""Model step (the expert layer): % of the profiled slice's busy device
time in operations named moe_ (csrc/moe.cu: routing, the permutation, the
grouped products, the combine). Moves score_rows_per_s."""

from benchmark.harness import trace


def read(run):
    s = run.summary
    seconds = trace.kernel_seconds(s, "moe_")
    if not s or s["busy_s"] <= 0 or seconds <= 0:
        return None
    return 100.0 * seconds / s["busy_s"]
