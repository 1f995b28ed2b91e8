"""CPU tests of the benchmark (run them with ``python -m pytest portbench/tests -q``).

Every run here is on the CPU, where the program's Renderer takes its
kernels' plain torch versions, at tiny sizes: the cells' scenes cut down,
64 x 128 frames. Nothing here needs the card; what does is run by
portbench/run.py on the card itself.
"""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from portbench import run

@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="session")
def manifest() -> dict:
    return run.load_json(run.ROOT / "BENCHMARK.json")


#: run.run_cell's frame counts at the tests' size.
TINY_FRAMES = dict(warmup_frames=1, compare_frames=2, trace_frames=2, bound_frames=2)


def tiny_cell(manifest: dict, workload: str) -> tuple[dict, dict, dict]:
    """A cell's configuration and traffic mix cut to the CPU tests' size
    (run them with TINY_FRAMES)."""
    cell, config, traffic = run.cell_files(manifest, workload)
    # Poses 0.3 rad apart: at 128 x 64 neighbouring poses of the real track
    # can give the same frame, and a stale frame would pass for a fresh one.
    config = dict(config, width=128, height=64, scene=dict(config["scene"], scale="small"))
    traffic = dict(traffic, track=dict(traffic["track"], step=0.3))
    return cell, config, traffic


@pytest.fixture
def tiny(manifest, tmp_path, monkeypatch):
    """tiny(workload) -> (config, traffic) of the cell at the tests' size,
    with the run's cache in a temporary directory."""
    monkeypatch.setattr(run, "CACHE", pathlib.Path(tmp_path) / "cache")

    def make(workload):
        _, config, traffic = tiny_cell(manifest, workload)
        return config, traffic

    return make


def dump(obj) -> str:
    return json.dumps(obj, sort_keys=True)
