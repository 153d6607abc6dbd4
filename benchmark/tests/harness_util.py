"""Helpers of the harness's tests: the repository's root, the tiny CPU
benchmark beside the tests, and a runner of the harness's command."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
TINY = os.path.join(ROOT, "benchmark", "tests", "tiny", "BENCHMARK.json")


def run_harness(*args, script=None, timeout=300, env=None):
    """(exit code, the last stdout line as JSON or None, stderr) of one run
    of ``benchmark/run.py`` (or ``script``)."""
    cmd = [sys.executable, script or os.path.join(ROOT, "benchmark", "run.py"), *args]
    e = dict(os.environ)
    e.update(env or {})
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=e)
    lines = [l for l in p.stdout.splitlines() if l.strip()]
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return p.returncode, last, p.stderr


def tiny_args(cell, seed=20251017, seconds=1, trace=0):
    return ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
            str(trace), "--device", "cpu", "--benchmark-json", TINY]
