"""BENCHMARK.json against the benchmark's contract, and the files it
names."""

import json
import os
import re

import pytest

from vkbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = manifest.load()


def all_metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"][1:]:
        assert word.startswith(tuple(MAN["paths"]))
        assert os.path.exists(manifest.ROOT / word)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + all_metrics(), ids=lambda e: e["name"])
def test_names_and_units_use_allowed_characters(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            text = entry[key]
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text


def test_names_are_unique():
    for group in (MAN["configs"], MAN["workloads"], all_metrics()):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_every_config_file_exists_and_loads(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("benchmark/configs/")
    data = manifest.config(MAN, cfg["name"])
    assert data["name"] == cfg["name"]
    for key in ("scene", "settings", "frame", "limits", "assumed"):
        assert key in data
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_every_cell_names_its_files_and_reports_enough(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    manifest.config(MAN, cell["config"])
    mix = manifest.traffic(cell["traffic"])
    assert mix["poses"]
    e2e = [m["name"] for m in manifest.metrics(MAN, cell["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics(MAN, cell["name"], True)


@pytest.mark.parametrize("metric", all_metrics(), ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(manifest.reader(metric["name"]).read)
    keys = {"name", "unit", "better", "source"}
    if metric in MAN["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        moved = [m for m in MAN["end_to_end"] if m["name"] == metric["moves"]]
        assert moved
        for cell in metric.get("workloads", []):
            assert cell in moved[0].get("workloads", [cell])
    assert set(metric) - {"workloads"} == keys
    for cell in metric.get("workloads", []):
        manifest.workload(MAN, cell)


def test_four_card_cells_are_few():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
