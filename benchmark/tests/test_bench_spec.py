"""BENCHMARK.json against the rules its format keeps: its keys, names and
limits, that every configuration, traffic mix and per-layer metric it
names has its file, that every cell reports setup_s, another end-to-end
metric and a per-layer metric, and that a full check of 24 cells (2 + 14
runs a cell, each run_seconds + 60 s, 180 s a cell to build, 1200 s
spare) fits in 12 hours."""

import json
import re

from benchmark.harness import BENCH, ROOT, load_cell, reader_path

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert reader_path(m["name"]).is_file()
        assert UNIT.match(m["unit"]) and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        cell = load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_a_full_check_fits():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
