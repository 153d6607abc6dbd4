"""With the timed path broken underneath, a run that skips the look for a
card and does everything else reads ``correct`` false: once for each fault
the cells can have (a one-card cell has no exchange between chips)."""

import pytest

from harness_util import run_harness, tiny_args, ROOT

FAULT_RUN = ("import sys; sys.path.insert(0, {root!r}); "
             "from benchmark.tools import faults; from benchmark.harness import main; "
             "ctx = faults.planted({fault!r}); ctx.__enter__(); sys.exit(main.main(sys.argv[1:]))")


@pytest.mark.parametrize("cell,fault", [("tiny-siglip.train", "unchanged"),
                                        ("tiny-siglip.train", "half_batch"),
                                        ("tiny-siglip.train", "schedule"),
                                        ("tiny-clip.score", "alter"),
                                        ("tiny-clip.serve", "alter")])
def test_fault_reads_not_correct(tmp_path, cell, fault):
    script = tmp_path / "faulty.py"
    script.write_text(FAULT_RUN.format(root=ROOT, fault=fault).replace("; ", "\n"))
    rc, line, err = run_harness(*tiny_args(cell, seed=3_000_000_033), script=str(script))
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
