"""Nothing under benchmark/ imports JAX, Flax or the JAX package, and the
reference imports nothing of the measured port: every import's top-level
name is compared whole (the port's own name begins with the JAX
package's). A run also refuses to report once such a module is loaded."""

import ast
import os

import pytest

from harness_util import ROOT, run_harness, tiny_args

BENCH = os.path.join(ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "multimodal_content_moderation_tpu"}
PORT = "multimodal_content_moderation_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _files(top):
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_files(BENCH)), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_imports(path):
    assert not set(_imports(path)) & JAX


def test_port_name_is_not_the_jax_package():
    assert PORT not in JAX and PORT.split(".")[0] != "multimodal_content_moderation_tpu"


@pytest.mark.parametrize("path", sorted(_files(os.path.join(BENCH, "reference"))),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imports(path))
    assert PORT not in names and "benchmark" not in names


def test_run_refuses_with_jax_loaded(tmp_path):
    # a module named jax on the path, imported by a site hook before the run
    (tmp_path / "jax.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text("import jax\n")
    env = {"PYTHONPATH": str(tmp_path) + os.pathsep + ROOT}
    rc, line, err = run_harness(*tiny_args("tiny-clip.score"), env=env)
    assert rc != 0 and line is None
    assert "forbidden modules loaded: ['jax']" in err
