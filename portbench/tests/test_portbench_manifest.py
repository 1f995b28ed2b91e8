"""BENCHMARK.json against the contract it is written to, and every cell's
files found by name."""

from __future__ import annotations

import pathlib
import re

import pytest

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]]


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["portbench"]
    assert all(LINE.match(w) for w in manifest["command"]) and len(manifest["command"]) <= 32
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines(manifest):
    names = [c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in manifest["configs"])) == len(manifest["configs"])
    assert len(set(w["name"] for w in manifest["workloads"])) == len(manifest["workloads"])
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and LINE.match(w["why"])
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(manifest["workloads"])


def test_bounds_and_metric_keys(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(manifest, cell):
    entry, config, traffic = run.cell_files(manifest, cell)
    for key in ("scene", "width", "height", "renderer", "source", "reduced", "assumed"):
        assert key in config
    for key in ("loop", "track", "poses", "renderer", "limits"):
        assert key in traffic
    assert traffic["track"]["source"] and set(traffic["limits"]) == {"max_lsb"}
    e2e = [m for m in manifest["end_to_end"] if _applies(m, cell)]
    per_layer = [m for m in manifest["per_layer"] if _applies(m, cell)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert any(x["name"] == m["moves"] for x in e2e), m["name"]
    for m in e2e + per_layer:
        reader = run.reader(m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)
    assert config["name"] == entry["config"]
    assert all(k in run.load_json(run.ROOT / "BENCHMARK.json")["configs"][0] for k in ("file",))


def test_config_files_lie_under_paths(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/") and (run.ROOT / f).is_file()
        assert pathlib.PurePosixPath(f).parts[0] in manifest["paths"]
