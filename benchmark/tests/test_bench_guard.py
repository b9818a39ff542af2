"""The import guard, and the runs that must end without a result: no card,
or a directory that holds only the benchmark's own files."""

import json
import shutil
import subprocess
import sys

from benchmark import harness, run


def test_forbidden_names_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "s2vt_tpu",
             "s2vt_tpu.ops.pallas_s2vt", "s2vt_tpu_torch", "s2vt_tpu_torch.ops",
             "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "s2vt_tpu",
         "s2vt_tpu.ops.pallas_s2vt"])


def test_harness_loads_no_forbidden_module():
    code = ("import sys, benchmark.run, benchmark.calibrate, benchmark.loops.train, "
            "benchmark.loops.caption, s2vt_tpu_torch.training.loop, "
            "s2vt_tpu_torch.evaluation.decode; from benchmark import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result(capsys):
    # this machine has no card: the run exits non-zero and prints no JSON
    rc = run.main(["--workload", "lstm.train.b16", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert not [line for line in capsys.readouterr().out.splitlines()
                if line.startswith("{")]


def test_bare_directory_exits_nonzero(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    for rel in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(harness.ROOT / rel, tmp_path / rel,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "lstm.train.b16", "--seed", "3", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not [line for line in out.stdout.splitlines() if line.startswith("{")]
