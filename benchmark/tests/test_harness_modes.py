"""Each of the three modes runs end to end on the CPU at the tiny width and
prints one result line in the contract's shape, in both kinds of run."""

import pytest

from harness_util import run_harness, tiny_args

E2E = {"score": "score_rows_per_s", "train": "train_samples_per_s", "serve": "serve_p95_ms"}


@pytest.mark.parametrize("cell,trace", [("tiny-clip.score", 0), ("tiny-siglip.score", 1),
                                        ("tiny-siglip.train", 0), ("tiny-clip.train", 1),
                                        ("tiny-clip.serve", 0), ("tiny-clip.serve", 1)])
def test_mode_prints_one_contract_line(cell, trace):
    rc, line, err = run_harness(*tiny_args(cell, seed=3_000_000_019, seconds=1, trace=trace))
    assert rc == 0, err[-3000:]
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    mode = cell.rsplit(".", 1)[1]
    if trace:
        # no device trace on the CPU: the device metrics are left out, never 0
        assert E2E[mode] not in line["metrics"]
        assert not any(k.startswith(("mfu", "attention_nhd", "device_idle", "peak_mem"))
                       for k in line["metrics"])
    else:
        assert set(line["metrics"]) == {E2E[mode], "setup_s"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    # the compared numbers are the last lines of standard error, each beside its limit
    tail = [l for l in err.splitlines() if l.strip()][-len(line["checks"]):]
    assert all(l.startswith("check ") and " limit " in l for l in tail)


def test_no_card_no_result():
    rc, line, err = run_harness("--workload", "siglip2-224.score-cached", "--seed", "1",
                                "--seconds", "1", "--trace", "0",
                                env={"CUDA_VISIBLE_DEVICES": ""})
    assert rc != 0 and line is None
    assert "no CUDA device" in err


def test_unknown_cell_no_result():
    rc, line, _ = run_harness("--workload", "no-such-cell", "--seed", "1", "--seconds", "1",
                              "--trace", "0")
    assert rc != 0 and line is None


def test_bare_checkout_no_result(tmp_path):
    # BENCHMARK.json and the files under paths alone: the program is missing
    import os
    import shutil

    from harness_util import ROOT

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    rc, line, _ = run_harness("--workload", "siglip2-224.score-cached", "--seed", "1",
                              "--seconds", "1", "--trace", "0", "--device", "cpu",
                              script=str(tmp_path / "benchmark" / "run.py"),
                              env={"PYTHONPATH": ""})
    assert rc != 0 and line is None
