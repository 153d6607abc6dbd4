"""The kernel libraries' file names follow their sources and the shared
headers, so an edited header rebuilds every kernel and a stale library is
never loaded (no nvcc needed: only the names are computed)."""

from multimodal_content_moderation_tpu_torch.ops import _build


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (csrc / "b.cu").write_text('#include "shared.cuh"\nint b;\n')
    (csrc / "shared.cuh").write_text("int shared;\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_lib_path_follows_the_shared_header(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = {n: _build._lib_path(n) for n in ("a", "b")}
    assert before["a"] != before["b"]
    assert _build._lib_path("a") == before["a"]  # the same sources, the same name
    (csrc / "shared.cuh").write_text("int shared_edited;\n")
    after = {n: _build._lib_path(n) for n in ("a", "b")}
    assert all(after[n] != before[n] for n in ("a", "b"))
    assert all(after[n].parent == _build.BUILD_DIR for n in ("a", "b"))


def test_lib_path_follows_its_source_and_new_headers(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    a, b = _build._lib_path("a"), _build._lib_path("b")
    (csrc / "a.cu").write_text('#include "shared.cuh"\nint a2;\n')
    assert _build._lib_path("a") != a and _build._lib_path("b") == b
    (csrc / "other.cuh").write_text("int other;\n")
    assert _build._lib_path("b") != b
