"""The port's packaging file (``setup_torch.py``) beside the JAX package's
``setup.py``.

- Each file is run with ``setuptools.setup`` replaced by a recorder: the
  port's packages are exactly ``multimodal_content_moderation_tpu_torch``
  and its subpackages, the JAX file's are the JAX package's, and the two
  sets share nothing (before the ``exclude=`` in ``setup.py`` the JAX glob
  took the port in too).
- ``package_data`` matches every file of ``csrc/`` (so that an installed
  port can build its kernels) and every JPEG fixture; ``install_requires``
  is torch and numpy only.
- The seven ``mmharm-torch-*`` console scripts import and are callable,
  and none shares a name with the JAX package's ``mmharm-*`` scripts.
"""

import fnmatch
import importlib
import os
from pathlib import Path

import pytest
import setuptools

REPO = Path(__file__).resolve().parent.parent
PORT = "multimodal_content_moderation_tpu_torch"
SCRIPTS = {"train", "evaluate", "infer", "export", "prepare-data", "deploy", "serve"}


def _setup_kwargs(name, monkeypatch):
    seen = {}
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(setuptools, "setup", lambda **kw: seen.update(kw))
    code = compile((REPO / name).read_text(), str(REPO / name), "exec")
    exec(code, {"__name__": "__main__", "__file__": str(REPO / name)})
    return seen


@pytest.fixture
def port(monkeypatch):
    return _setup_kwargs("setup_torch.py", monkeypatch)


@pytest.fixture
def jax_pkg(monkeypatch):
    return _setup_kwargs("setup.py", monkeypatch)


def _scripts(kw):
    return dict(s.split("=", 1) for s in kw["entry_points"]["console_scripts"])


def test_package_sets_are_disjoint(port, jax_pkg):
    on_disk = {
        ".".join(p.relative_to(REPO).parts[:-1])
        for p in (REPO / PORT).rglob("__init__.py")
    }
    assert set(port["packages"]) == on_disk
    assert all(p == PORT or p.startswith(PORT + ".") for p in port["packages"])
    assert not set(port["packages"]) & set(jax_pkg["packages"])
    assert "multimodal_content_moderation_tpu" in jax_pkg["packages"]
    assert port["name"] == "multimodal-content-moderation-tpu-torch" != jax_pkg["name"]


def test_package_data_ships_every_kernel_source_and_fixture(port):
    globs = port["package_data"][PORT]
    root = REPO / PORT
    for sub in ("csrc", "testdata/jpeg"):
        files = [p for p in (root / sub).iterdir() if p.is_file()]
        assert files
        for p in files:
            rel = p.relative_to(root).as_posix()
            assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
    cu = [p.name for p in (root / "csrc").glob("*.cu")]
    assert len(cu) == 6


def test_requirements_are_torch_and_numpy(port):
    assert sorted(port["install_requires"]) == ["numpy", "torch"]
    extras = {r for reqs in port["extras_require"].values() for r in reqs}
    assert {"pyyaml", "pillow", "pandas", "regex", "safetensors"} <= extras


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_console_scripts_import(port, jax_pkg, script):
    scripts = _scripts(port)
    assert set(scripts) == {f"mmharm-torch-{s}" for s in SCRIPTS}
    assert not set(scripts) & set(_scripts(jax_pkg))
    module, attr = scripts[f"mmharm-torch-{script}"].split(":")
    assert module.startswith(PORT + ".")
    assert callable(getattr(importlib.import_module(module), attr))
    assert os.path.exists(REPO / (module.replace(".", "/") + ".py"))
