"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds by that name."""

import json
import re

import pytest

from benchmark import harness, plugins

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = {w["name"] for w in M["workloads"]}


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert M["command"] == ["python3", "benchmark/run.py"] and M["paths"] == ["benchmark"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_entries_have_just_the_contract_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_text_fields():
    entries = M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names)), group
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES, m
    for e in M["configs"] + M["workloads"]:
        assert NAME.match(e.get("config", e["name"])) and NAME.match(e.get("traffic", e["name"]))
    for text in [e["why"] for e in M["configs"] + M["workloads"]] + [c["source"] for c in M["configs"]] + \
            [m["layer"] for m in M["per_layer"]] + M["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_end_to_end_bounds():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
        assert set(m.get("workloads", CELLS)) <= CELLS


def test_cells_resolve_to_their_files():
    for w in M["workloads"]:
        cell, config, traffic = harness.resolve(M, w["name"])
        assert cell["chips"] in (1, 4) and config["cards"] == cell["chips"]
        assert plugins.path("ops", traffic["op"]).is_file(), traffic["op"]
        for spec in (v for v in traffic.values() if isinstance(v, dict) and "dist" in v):
            assert plugins.path("dists", spec["dist"]).is_file(), spec
    for c in M["configs"]:
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((harness.ROOT / c["file"]).read_text())["reduced"]
        assert any(w["config"] == c["name"] for w in M["workloads"]), c["name"]
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_four_card_cells_at_most_a_quarter():
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("metric", [m["name"] for m in M["end_to_end"] + M["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric).read)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.metrics_of(M, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert harness.metrics_of(M, cell, "per_layer"), cell


def test_moves_names_an_end_to_end_metric_of_the_same_cells():
    e2e = {m["name"]: set(m.get("workloads", CELLS)) for m in M["end_to_end"]}
    layers = {}
    for m in M["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert set(m.get("workloads", CELLS)) <= e2e[m["moves"]], m["name"]
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(len(layer.splitlines()) == 1 for layer in layers)
