"""A configuration, a traffic mix, a cell and a per-layer metric are added
to a copy of the benchmark as new files only (and entries in
BENCHMARK.json): the harness finds them by name and the new metric shows in
the new cell's traced line. So is a model family with its own reference:
its cell reads correct, and not correct where the reference leaves out a
layer the port runs."""

import hashlib
import json
import os
import shutil

import pytest

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


def _snapshot(top):
    out = {}
    for d, dirs, fs in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, top)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


# the family's reference with the text and image poolers left out: the
# first position as it is, where the port pools it through a tanh dense
NO_POOLER = '''

def _pool(pr, x, P, name):
    return x[:, 0]
'''


@pytest.mark.parametrize("pooler", [True, False], ids=["reference", "pooler_left_out"])
def test_add_family_as_files(tmp_path, pooler):
    # a third model family, the port's generic backend, as new files in a
    # copy of the benchmark: the family's module with its own plain
    # reference, a configuration, a mix, limits and BENCHMARK.json entries
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    before = _snapshot(b)
    new = os.path.join(ROOT, "benchmark", "tests", "tiny", "new_family")
    family = open(os.path.join(new, "vitbert.py")).read()
    (b / "families" / "vitbert.py").write_text(family if pooler else family + NO_POOLER)
    shutil.copy(os.path.join(new, "tiny-vitbert.json"), b / "configs" / "tiny-vitbert.json")
    shutil.copy(os.path.join(ROOT, "benchmark", "tests", "tiny", "traffic", "score.json"),
                b / "traffic" / "tiny-score.json")
    # bf16 against fp32 at width 64 reads 0.011-0.039 on two seeds; without
    # the poolers 2.07-2.11
    (b / "limits" / "tiny-vitbert.score.json").write_text(json.dumps({"max_abs_logit_gap": 0.1}))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"].append({"name": "tiny-vitbert", "source": "test",
                            "file": "benchmark/configs/tiny-vitbert.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "tiny-vitbert.score", "config": "tiny-vitbert",
                              "traffic": "tiny-score", "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("tiny-vitbert.score")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line, err = run_harness("--workload", "tiny-vitbert.score", "--seed", "3000000077",
                                "--seconds", "1", "--trace", "0", "--device", "cpu",
                                "--benchmark-json", str(tmp_path / "BENCHMARK.json"),
                                script=str(b / "run.py"), env={"PYTHONPATH": ROOT})
    assert rc == 0, err[-3000:]
    assert set(line["metrics"]) == {"score_rows_per_s", "setup_s"}
    assert line["correct"] is pooler, line["checks"]
    after = _snapshot(b)
    assert {k: after[k] for k in before} == before  # no file of the copy was edited

    # a function the family does not give fails by the family's name and its own
    from benchmark.harness import spec as bench_spec

    cfg = bench_spec.load_cell("tiny-vitbert.score", str(tmp_path / "BENCHMARK.json")).config
    assert cfg["family_file"] == str(b / "families" / "vitbert.py")
    with pytest.raises(AttributeError, match=r"'vitbert' .* has no backbone_ops\(\)"):
        bench_spec.family(cfg).backbone_ops
