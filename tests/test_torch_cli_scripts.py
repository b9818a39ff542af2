"""The port's console scripts: every ``s2vt-torch-*`` entry of
pyproject.toml's ``[project.scripts]`` names a callable of
``s2vt_tpu_torch.cli``, pairs with the JAX package's script of the same
task, and answers ``--help`` with exit code 0, called as the installed
script calls it (no arguments, ``sys.argv`` set). A run that succeeds
exits with code 0 through ``sys.exit(fn())``, whatever the module's main
returns."""

import importlib
import os
import sys
import tomllib

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("train", "eval", "prepare-captions", "extract-features", "export-serving")


def _scripts() -> dict:
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def test_every_jax_script_has_a_port_script():
    scripts = _scripts()
    port = {k for k in scripts if k.startswith("s2vt-torch-")}
    assert port == {f"s2vt-torch-{t}" for t in TASKS}
    assert {f"s2vt-{t}" for t in TASKS} <= set(scripts)
    for task in TASKS:
        assert scripts[f"s2vt-{task}"].startswith("s2vt_tpu.cli:")
        port_fn = scripts[f"s2vt-torch-{task}"].split(":")[1]
        assert scripts[f"s2vt-{task}"] == f"s2vt_tpu.cli:{port_fn}"


@pytest.mark.parametrize("task", TASKS)
def test_port_script_resolves_and_answers_help(task, monkeypatch, capsys):
    module, attr = _scripts()[f"s2vt-torch-{task}"].split(":")
    assert module == "s2vt_tpu_torch.cli"
    fn = getattr(importlib.import_module(module), attr)
    assert callable(fn)
    monkeypatch.setattr(sys, "argv", [f"s2vt-torch-{task}", "--help"])
    with pytest.raises(SystemExit) as exit_info:
        fn()
    assert exit_info.value.code == 0
    assert capsys.readouterr().out.startswith("usage:")


@pytest.mark.parametrize("task,result", [
    ("train", object()), ("eval", {"CIDEr": 0.5}), ("prepare-captions", {"word2ix": {}}),
    ("extract-features", 178), ("export-serving", "serving/")])
def test_port_script_exits_zero_whatever_main_returns(task, result, monkeypatch):
    """The installed script runs ``sys.exit(fn())``: whatever the module's
    main returns (the Trainer, a scores dict, a clip count), the script's exit
    code is 0."""
    module, attr = _scripts()[f"s2vt-torch-{task}"].split(":")
    fn = getattr(importlib.import_module(module), attr)
    cli_module = {"train": "train", "eval": "eval", "prepare-captions": "prepare",
                  "extract-features": "extract", "export-serving": "export_serving"}[task]
    target = importlib.import_module(f"s2vt_tpu_torch.cli.{cli_module}")
    monkeypatch.setattr(target, "main", lambda *a, **k: result)
    with pytest.raises(SystemExit) as exit_info:
        sys.exit(fn())
    assert exit_info.value.code is None


def test_prepare_script_real_run_exits_zero(tmp_path, monkeypatch, capsys):
    """s2vt-torch-prepare-captions on a small MSVD CSV, called as the
    installed script calls it: it writes both files and exits with code 0."""
    rows = [f"vid{v}x,{v},{v + 5},{100 + c},clean,{10 + v},English,"
            f"A {w} is playing number {c}." for v in range(6) for c, w in
            enumerate(["man", "dog", "cat"])]
    csv_file = tmp_path / "video_corpus.csv"
    csv_file.write_text("VideoID,Start,End,WorkerID,Source,AnnotationTime,Language,"
                        "Description\n" + "\n".join(rows) + "\n", encoding="utf-8")
    module, attr = _scripts()["s2vt-torch-prepare-captions"].split(":")
    fn = getattr(importlib.import_module(module), attr)
    monkeypatch.setattr(sys, "argv", [
        "s2vt-torch-prepare-captions", "msvd", "--csv_file", str(csv_file),
        "--captions_file", str(tmp_path / "captions.json"),
        "--gts_file", str(tmp_path / "gts.json"),
        "--n_train", "3", "--n_valid", "2", "--seed", "0"])
    with pytest.raises(SystemExit) as exit_info:
        sys.exit(fn())
    assert exit_info.value.code is None
    assert (tmp_path / "captions.json").is_file() and (tmp_path / "gts.json").is_file()
    assert capsys.readouterr().out.startswith("vocab size: ")
