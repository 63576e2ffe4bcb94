"""The port's kernel build (``repro_torch.kernels._build``) on the CPU: which
library a source maps to. Nothing is compiled here."""

from repro_torch.kernels import _build


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "helpers.cuh"\n')
    (csrc / "helpers.cuh").write_text("// helpers\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_library_path_is_stable_for_unchanged_sources(tmp_path, monkeypatch):
    _csrc(tmp_path, monkeypatch)
    path = _build.library_path("kern")
    assert path == _build.library_path("kern")
    assert path.parent == tmp_path / "build"
    assert path.name.startswith("kern-") and path.suffix == ".so"


def test_header_edit_changes_library_path(tmp_path, monkeypatch):
    """A source may include any ``csrc/*.cuh``: an edited header must not
    load the library built from the old one."""
    csrc = _csrc(tmp_path, monkeypatch)
    before = _build.library_path("kern")
    (csrc / "helpers.cuh").write_text("// helpers, edited\n")
    edited = _build.library_path("kern")
    assert edited != before
    (csrc / "more.cuh").write_text("// a new header\n")
    assert _build.library_path("kern") not in (before, edited)


def test_source_and_flag_edits_change_library_path(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    paths = {_build.library_path("kern")}
    (csrc / "kern.cu").write_text('#include "helpers.cuh"\n// edited\n')
    paths.add(_build.library_path("kern"))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    paths.add(_build.library_path("kern"))
    assert len(paths) == 3
