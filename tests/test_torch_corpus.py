"""The port's corpus preparation against s2vt_tpu's, on the CPU.

``parse_csv`` (the standard ``csv`` module) and JAX's (pandas ``read_csv`` +
``dropna``) read the same CSV and must write byte-equal ``captions.json``
and ``gts.json``; so must ``parse_msr_vtt`` and ``cli.prepare.main`` for both
subcommands, which also print the same line. One case per pandas rule that
the port's module docstring lists.
"""

import json
import sys

import numpy as np
import pytest

from s2vt_tpu_torch.cli import prepare as port_prepare
from s2vt_tpu_torch.data import corpus as port_corpus

jcorpus = pytest.importorskip("s2vt_tpu.data.corpus")

HEADER = "VideoID,Start,End,WorkerID,Source,AnnotationTime,Language,Description"


def _msvd_rows(n_videos=6, seed=0):
    """MSVD-format rows: several captions per clip, English and other
    languages, clean and unverified sources."""
    rng = np.random.default_rng(seed)
    words = ["a", "man", "is", "playing", "guitar", "dog", "runs", "the", "cat", "sleeps",
             "woman", "cooking", "slicing", "onion"]
    rows = []
    for v in range(n_videos):
        vid, start = f"vid{v:02d}x", int(rng.integers(0, 50))
        end = start + int(rng.integers(2, 20))
        for c in range(int(rng.integers(2, 6))):
            lang = "English" if c % 4 != 3 else "French"
            src = "clean" if c % 3 != 2 else "unverified"
            sent = " ".join(rng.choice(words, int(rng.integers(3, 8)))).capitalize() + "."
            rows.append([vid, str(start), str(end), str(100 + c), src, str(10 + v), lang, sent])
    return rows


def _csv_text(rows, header=HEADER):
    return header + "\n" + "".join(",".join(r) + "\n" for r in rows)


def _run_both(tmp_path, csv_text, **kw):
    """parse_csv of both packages on one CSV: (port result, JAX result), after
    asserting that both wrote the same bytes."""
    csv_file = tmp_path / "video_corpus.csv"
    csv_file.write_bytes(csv_text.encode("utf-8"))
    out = {}
    for name, mod in (("port", port_corpus), ("jax", jcorpus)):
        out[name] = mod.parse_csv(str(csv_file), str(tmp_path / f"{name}_captions.json"),
                                  str(tmp_path / f"{name}_gts.json"), **kw)
    for f in ("captions", "gts"):
        assert (tmp_path / f"port_{f}.json").read_bytes() == \
            (tmp_path / f"jax_{f}.json").read_bytes(), f
    assert out["port"] == out["jax"]
    return out["port"], out["jax"]


def test_parse_csv_matches_jax_on_the_test_data_fixture(tmp_path):
    """The fixture of tests/test_data.py::test_parse_csv_roundtrip, written
    by pandas as that test writes it."""
    import pandas as pd
    rows = []
    for i in range(8):
        rows.append({"VideoID": f"vid{i}", "Start": i, "End": i + 10, "Language": "English",
                     "Source": "clean", "Description": f"a cat number {i} jumps."})
        rows.append({"VideoID": f"vid{i}", "Start": i, "End": i + 10, "Language": "English",
                     "Source": "clean", "Description": "the animal runs"})
    rows.append({"VideoID": "vidX", "Start": 0, "End": 1, "Language": "French",
                 "Source": "clean", "Description": "le chat"})
    pd.DataFrame(rows).to_csv(tmp_path / "fixture.csv", index=False)
    text = (tmp_path / "fixture.csv").read_text(encoding="utf-8")
    port, _ = _run_both(tmp_path, text, clean_only=True, split_sizes=(4, 2), seed=123)
    assert len(port["captions"]) == 8 and "vid0_0_10" in port["captions"]
    assert [len(port["splits"][k]) for k in ("train", "valid", "test")] == [4, 2, 2]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("min_feq", [1, 2])
@pytest.mark.parametrize("clean_only", [False, True])
def test_parse_csv_matches_jax(tmp_path, clean_only, min_feq, seed):
    port, _ = _run_both(tmp_path, _csv_text(_msvd_rows(8, seed)), clean_only=clean_only,
                        min_feq=min_feq, split_sizes=(4, 2), seed=seed)
    assert port["splits"]["train"] and port["splits"]["test"]


def _one_clip(description, **fields):
    """Three rows of clip ab 1-5; the middle one carries ``description`` and
    the field overrides."""
    base = dict(VideoID="ab", Start="1", End="5", WorkerID="7", Source="clean",
                AnnotationTime="3", Language="English")
    rows = [[*base.values(), "a dog runs"]]
    rows.append([*{**base, **fields}.values(), description])
    rows.append(["cd", "2", "6", "8", "clean", "4", "English", "a cat sleeps"])
    return rows


@pytest.mark.parametrize("field", ["WorkerID", "AnnotationTime", "Description"])
def test_an_empty_field_in_any_column_drops_its_row(tmp_path, field):
    rows = _one_clip("a man cooks" if field != "Description" else "", **(
        {field: ""} if field != "Description" else {}))
    port, _ = _run_both(tmp_path, _csv_text(rows), split_sizes=(1, 1), seed=0)
    assert sum(len(c) for c in port["captions"].values()) == 2
    assert "cooks" not in port["word2ix"]


@pytest.mark.parametrize("na", ["NA", "None", "null", "nan", "N/A", '"NA"', "NULL", "n/a"])
def test_pandas_na_strings_drop_their_row(tmp_path, na):
    port, _ = _run_both(tmp_path, _csv_text(_one_clip(na)), split_sizes=(1, 1), seed=0)
    assert sum(len(c) for c in port["captions"].values()) == 2


def test_an_empty_number_turns_its_column_into_floats(tmp_path):
    """One empty Start anywhere: every clip id prints its Start as a float."""
    rows = _one_clip("a man cooks", Start="") + [
        ["ef", "12", "30", "9", "clean", "5", "English", "people dance"]]
    port, _ = _run_both(tmp_path, _csv_text(rows), split_sizes=(1, 1), seed=0)
    assert sorted(port["captions"]) == ["ab_1.0_5", "cd_2.0_6", "ef_12.0_30"]


@pytest.mark.parametrize("start, want", [("007", "ab_7_5"), (" 1", "ab_1_5"),
                                         ("1.5", "ab_1.5_5"), ("1e1", "ab_10.0_5"),
                                         ("x1", "ab_x1_5")])
def test_number_columns_print_as_pandas_infers_them(tmp_path, start, want):
    rows = [["ab", start, "5", "7", "clean", "3", "English", "a dog runs"],
            ["cd", "2", "6", "8", "clean", "4", "English", "a cat sleeps"]]
    port, _ = _run_both(tmp_path, _csv_text(rows), split_sizes=(1, 1), seed=0)
    assert want in port["captions"]


def test_descriptions_keep_spaces_and_quoted_commas(tmp_path):
    rows = _one_clip('"  a dog, and a cat, play  "')
    port, _ = _run_both(tmp_path, _csv_text(rows), split_sizes=(1, 1), seed=0)
    with open(tmp_path / "port_gts.json", encoding="utf-8") as f:
        caps = [c["caption"] for c in json.load(f)["gts"]["ab_1_5"]]
    assert caps == ["a dog runs", "  a dog, and a cat, play  "]


def test_quoted_newlines_blank_lines_and_short_rows(tmp_path):
    text = (HEADER + "\n\nab,1,5,7,clean,3,English,\"a dog\nruns\"\n\n"
            "cd,2,6,8,clean,4,English\n"
            "ef,3,7,9,clean,5,English,a cat sleeps\n")
    port, _ = _run_both(tmp_path, text, split_sizes=(1, 1), seed=0)
    assert sorted(port["captions"]) == ["ab_1_5", "ef_3_7"]


def test_unicode_descriptions_and_a_byte_order_mark(tmp_path):
    rows = _one_clip('"Un café très chaud, naïve façade — 猫が寝ている"')
    rows.append(["gh", "4", "9", "1", "clean", "2", "English", "Ölçek über straße"])
    port, _ = _run_both(tmp_path, "\ufeff" + _csv_text(rows), split_sizes=(1, 1), seed=3)
    assert "café" in port["word2ix"] and "gh_4_9" in port["captions"]


def test_a_row_with_too_many_fields_raises(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text(HEADER + "\nab,1,5,7,clean,3,English,a dog,extra\n", encoding="utf-8")
    with pytest.raises(ValueError, match="fields"):
        port_corpus.parse_csv(str(path), str(tmp_path / "c.json"), str(tmp_path / "g.json"))


def _msrvtt_files(tmp_path):
    """The fixture of tests/test_corpus_msrvtt.py."""
    train_val = {
        "videos": [{"video_id": "video0", "split": "train"},
                   {"video_id": "video1", "split": "train"},
                   {"video_id": "video2", "split": "validate"}],
        "sentences": [{"video_id": "video0", "caption": "A man plays guitar."},
                      {"video_id": "video0", "caption": "a man is playing a guitar"},
                      {"video_id": "video1", "caption": "a cat sleeps"},
                      {"video_id": "video2", "caption": "people are dancing"}]}
    test = {"videos": [{"video_id": "video3", "split": "test"}]}
    tv, te = tmp_path / "train_val.json", tmp_path / "test.json"
    tv.write_text(json.dumps(train_val))
    te.write_text(json.dumps(test))
    return str(tv), str(te)


@pytest.mark.parametrize("min_feq", [1, 2])
def test_parse_msr_vtt_matches_jax(tmp_path, min_feq):
    tv, te = _msrvtt_files(tmp_path)
    out = {}
    for name, mod in (("port", port_corpus), ("jax", jcorpus)):
        out[name] = mod.parse_msr_vtt(tv, te, str(tmp_path / f"{name}_c.json"),
                                      str(tmp_path / f"{name}_g.json"), min_feq=min_feq)
    assert out["port"] == out["jax"]
    assert out["port"]["splits"] == {"train": ["video0", "video1"], "valid": ["video2"],
                                     "test": ["video3"]}
    for f in ("c", "g"):
        assert (tmp_path / f"port_{f}.json").read_bytes() == \
            (tmp_path / f"jax_{f}.json").read_bytes()


@pytest.mark.parametrize("dataset", ["msvd", "msr-vtt"])
def test_cli_prepare_matches_jax(tmp_path, monkeypatch, capsys, dataset):
    """Both CLIs with the same flags: the same files and the same line."""
    jprepare = pytest.importorskip("s2vt_tpu.cli.prepare")
    if dataset == "msvd":
        csv_file = tmp_path / "video_corpus.csv"
        csv_file.write_text(_csv_text(_msvd_rows(8, 4)), encoding="utf-8")
        flags = ["--csv_file", str(csv_file), "--n_train", "4", "--n_valid", "2",
                 "--seed", "11", "--clean_only", "--min_feq", "2"]
    else:
        tv, te = _msrvtt_files(tmp_path)
        flags = ["--train_source_file", tv, "--test_source_file", te]
    lines = {}
    for name in ("port", "jax"):
        argv = [dataset, *flags, "--captions_file", str(tmp_path / f"{name}_c.json"),
                "--gts_file", str(tmp_path / f"{name}_g.json")]
        if name == "port":
            port_prepare.main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["prepare", *argv])
            jprepare.main()
        lines[name] = capsys.readouterr().out
    assert lines["port"] == lines["jax"] and lines["port"].startswith("vocab size: ")
    for f in ("c", "g"):
        assert (tmp_path / f"port_{f}.json").read_bytes() == \
            (tmp_path / f"jax_{f}.json").read_bytes()
