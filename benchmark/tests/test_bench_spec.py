"""BENCHMARK.json against the contract it is written to, and the files the
harness finds by its names."""

import json
import math
import re

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert (harness.ROOT / p).is_dir() and not p.endswith("_torch")


def test_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    items = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for item in items:
        assert NAME.match(item["name"]), item["name"]
        for key in ("why", "layer", "source"):
            if key in item:
                assert 1 <= len(item[key]) <= 200 and "\n" not in item[key]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [i["name"] for i in items]
    assert len(names) == len(set(names))


def test_configs():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert all(k in cfg for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "hidden", "embed")) for k in c["reduced"])
        assert any(c["name"] == w["config"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    _, cfg, traffic, limits = harness.cell_files(SPEC, cell["name"])
    assert (harness.HERE / "loops" / f"{traffic['loop']}.py").is_file()
    assert limits and all(math.isfinite(v) and v >= 0 for v in limits.values())
    e2e = [m["name"] for m in harness.metrics_of(SPEC, cell["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.metrics_of(SPEC, cell["name"], "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
