"""A configuration, a traffic mix, a cell and a per-layer metric are added
to a copy of the benchmark as new files only (and entries in
BENCHMARK.json): the harness finds them by name and the new metric shows in
the new cell's traced line."""

import json
import os
import shutil

from harness_util import ROOT, run_harness


def test_add_cell_and_metric_as_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    tiny = os.path.join(ROOT, "benchmark", "tests", "tiny")
    b = tmp_path / "benchmark"
    # new files only: a configuration, a mix, limits and a reader
    cfg = json.load(open(os.path.join(tiny, "configs", "tiny-clip.json")))
    cfg["name"] = "tiny-clip-wide-head"
    cfg["head"]["fusion_dim"] = 48
    (b / "configs" / "tiny-clip-wide-head.json").write_text(json.dumps(cfg))
    mix = json.load(open(os.path.join(tiny, "traffic", "score.json")))
    mix["batch"] = 4
    (b / "traffic" / "score-b4.json").write_text(json.dumps(mix))
    (b / "limits" / "tiny-wide.score-b4.json").write_text(json.dumps({"max_abs_logit_gap": 0.05}))
    (b / "metrics" / "rows_attempted.score.py").write_text(
        '"""Rows the run attempted."""\n\n\ndef read(run):\n    return run.attempted\n')
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"].append({"name": cfg["name"], "source": cfg["source"],
                            "file": "benchmark/configs/tiny-clip-wide-head.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "tiny-wide.score-b4", "config": cfg["name"],
                              "traffic": "score-b4", "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("tiny-wide.score-b4")
    spec["per_layer"].append({"name": "rows_attempted.score", "unit": "rows", "better": "higher",
                              "source": "program_counter", "layer": "engine",
                              "moves": "score_rows_per_s", "workloads": ["tiny-wide.score-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    args = ["--workload", "tiny-wide.score-b4", "--seed", "99", "--seconds", "1",
            "--device", "cpu", "--benchmark-json", str(tmp_path / "BENCHMARK.json")]
    rc, line, err = run_harness(*args, "--trace", "1", script=str(b / "run.py"),
                                env={"PYTHONPATH": ROOT})
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    assert line["metrics"]["rows_attempted.score"]["value"] == line["attempted"]
    rc, line, err = run_harness(*args, "--trace", "0", script=str(b / "run.py"),
                                env={"PYTHONPATH": ROOT})
    assert rc == 0 and "score_rows_per_s" in line["metrics"]
