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


def test_library_name_covers_the_shared_header(toolkit):
    """An edit of a shared header names every library anew, so no source is
    loaded from a build of an older header."""
    csrc, _, _ = toolkit
    before = _build.library_path("k")
    (csrc / "common.cuh").write_text("// helpers v1\n")
    with_header = _build.library_path("k")
    (csrc / "common.cuh").write_text("// helpers v2\n")
    assert len({before, with_header, _build.library_path("k")}) == 3


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


PORT_SOURCES = {"fused_s2vt_fwd": "s2vt_tpu/ops/pallas_s2vt.py::_fwd_kernel",
                "fused_s2vt_bwd": "s2vt_tpu/ops/pallas_s2vt.py::_bwd_kernel",
                "lstm_seq_fwd": "s2vt_tpu/ops/pallas_rnn.py::_fwd_kernel",
                "lstm_seq_bwd": "s2vt_tpu/ops/pallas_rnn.py::_bwd_kernel",
                "att_decode_fwd": "s2vt_tpu/ops/pallas_att_decode.py::_kernel",
                "gru_seq_fwd": "s2vt_tpu/ops/pallas_gru.py::_fwd_kernel",
                "gru_seq_bwd": "s2vt_tpu/ops/pallas_gru.py::_bwd_kernel",
                "argmax_linear": "s2vt_tpu/ops/pallas_decode.py::_kernel",
                "conv3x3_bn_relu": "s2vt_tpu/ops/pallas_conv.py::_conv_kernel"}


def test_build_all_compiles_every_port_source(tmp_path, monkeypatch):
    """The port's own csrc/ holds one source per kernel, and build_all starts
    one (fake) nvcc for each of them."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, fail=False))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setenv("CUDA_HOME", str(home))
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(PORT_SOURCES)
    outs = _build.build_all(sorted(PORT_SOURCES))
    assert [p.name.split("-")[0] for p in outs] == sorted(PORT_SOURCES)
    assert set(_build.build_logs) == set(PORT_SOURCES)


@pytest.mark.parametrize("name", sorted(PORT_SOURCES))
def test_each_source_names_the_tpu_kernel_it_replaces(name):
    """Each kernel's source opens with the TPU kernel it replaces, which
    exists in the JAX package, and exports a launch entry point and the
    error-string function that ``_build.load`` binds, with a plain C
    interface."""
    root = _build.CSRC.parents[1]
    text = (_build.CSRC / f"{name}.cu").read_text()
    replaced = PORT_SOURCES[name]
    assert f"// Replaces {replaced}" in text
    path, func = replaced.split("::")
    assert f"def {func}(" in (root / path).read_text()
    assert 'extern "C"' in text and f"int {name.replace('fused_s2vt', 's2vt_fused')}(" in text
    assert "const char* s2vt_cuda_error_string(int err)" in text


@pytest.mark.parametrize("name", sorted(PORT_SOURCES))
def test_each_source_takes_shared_helpers_from_the_header(name):
    """The bf16 rounding and the warp reduce-scatter live once, in
    csrc/common.cuh; a source includes it and keeps no copy of its own."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    header = (_build.CSRC / "common.cuh").read_text()
    for helper in ("float round_bf16(float v)", "void reduce_scatter_step(",
                   "void reduce_scatter("):
        assert helper in header and helper not in text
    if "reduce_scatter(" in text or "round_bf16(" in text:
        assert '#include "common.cuh"' in text


def test_ptxas_entries_reads_each_kernel_of_the_report():
    """nvcc's -Xptxas -v report as it reads on the card's machine: one
    (kernel, registers, spill stores, spill loads) per entry function, the
    mangled name read back to the kernel and its template arguments."""
    mangled = ("_ZN51_GLOBAL__N__dcf086c9_18_conv3x3_bn_relu_cu_5c8ebb6c26conv3x3_bn_relu_"
               "kernel_mmaI13__nv_bfloat16Li128EEEvPKT_S4_PKfS6_PS2_iiiiii")
    direct = ("_ZN51_GLOBAL__N__dcf086c9_18_conv3x3_bn_relu_cu_5c8ebb6c22conv3x3_bn_relu_"
              "kernelIfEEvPKT_S3_PKfS5_PS1_iiii")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
        f"ptxas info    : Function properties for {mangled}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 124 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{direct}' for 'sm_90a'",
        f"ptxas info    : Function properties for {direct}",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 43264 bytes smem",
        "ptxas info    : Compiling entry function 'plain_c_kernel' for 'sm_90a'",
        "ptxas info    : Used 12 registers"])
    assert _build.ptxas_entries(log) == [
        ("conv3x3_bn_relu_kernel_mma<nv_bfloat16, 128>", 124, 0, 0),
        ("conv3x3_bn_relu_kernel<float>", 64, 4, 4), ("plain_c_kernel", 12, 0, 0)]
    assert _build.kernel_symbol_name("_ZN4name6kernelILb1EEEvv") == "_ZN4name6kernelILb1EEEvv"
