"""The kernel build helper (s2vt_tpu_torch/ops/_build.py), driven by a fake
nvcc so that its naming, caching and error paths run without the toolkit."""

import os
import stat
import sys

import pytest

from s2vt_tpu_torch.ops import _build

_FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
if {fail}:
    print("error: fake compile failure", file=sys.stderr)
    sys.exit(2)
out = args[args.index("-o") + 1]
open(out, "wb").write(b"not a real library")
print("ptxas info    : Used 42 registers")
"""


@pytest.fixture
def toolkit(tmp_path, monkeypatch):
    """A source dir with one kernel, an empty build dir, and a fake CUDA
    home whose nvcc is a Python script (``fail`` selects its exit)."""
    csrc, build_dir, home = tmp_path / "csrc", tmp_path / "build", tmp_path / "cuda"
    csrc.mkdir()
    (home / "bin").mkdir(parents=True)
    (csrc / "k.cu").write_text("// kernel source v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setenv("CUDA_HOME", str(home))

    def make_nvcc(fail: bool):
        nvcc = home / "bin" / "nvcc"
        nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, fail=fail))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        return nvcc

    return csrc, build_dir, make_nvcc


def test_build_compiles_once_and_names_by_source(toolkit):
    csrc, build_dir, make_nvcc = toolkit
    make_nvcc(fail=False)
    out = _build.build("k")
    assert out.parent == build_dir and out.name.startswith("k-") and out.suffix == ".so"
    assert "42 registers" in _build.build_logs["k"]
    assert os.listdir(build_dir) == [out.name]          # no temporary left behind
    _build.build_logs.clear()
    assert _build.build("k") == out and not _build.build_logs   # reused, not rebuilt
    (csrc / "k.cu").write_text("// kernel source v2\n")
    assert _build.library_path("k") != out


def test_build_all_compiles_every_source_once(toolkit):
    csrc, build_dir, make_nvcc = toolkit
    (csrc / "k2.cu").write_text("// second kernel\n")
    make_nvcc(fail=False)
    first = _build.build("k")
    _build.build_logs.clear()
    outs = _build.build_all(["k", "k2"])
    assert outs[0] == first and outs[1].name.startswith("k2-")
    assert set(_build.build_logs) == {"k2"}             # k was reused, k2 compiled
    assert sorted(os.listdir(build_dir)) == sorted(p.name for p in outs)


def test_build_reports_compiler_errors(toolkit):
    _, build_dir, make_nvcc = toolkit
    make_nvcc(fail=True)
    with pytest.raises(RuntimeError, match="fake compile failure"):
        _build.build("k")
    assert not build_dir.exists() or not any(p.suffix == ".so" for p in build_dir.iterdir())


def test_find_nvcc_without_toolkit_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
