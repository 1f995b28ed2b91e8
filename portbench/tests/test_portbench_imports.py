"""What a run imports and reads: never jax or the JAX package (compared by
whole top-level names: tpurast_torch begins with tpurast), never the JAX
package's files, bench.py, chip_smoke.py or tools/; and the reference
imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from portbench import run

#: The recipes and the reference: neither may import the program.
PLAIN = sorted((run.BENCH / "recipes").glob("*.py")) + sorted((run.BENCH / "reference").glob("*.py"))

RUN_TINY = r"""
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args and
                 isinstance(args[0], (str, bytes)) else None)
import torch
torch.set_num_threads(2)
from portbench import run
from portbench.tests.conftest import TINY_FRAMES, tiny_cell
m = run.load_json(run.ROOT / "BENCHMARK.json")
for w in ("porsche_class_1080p.viewer_orbit", "porsche_class_1080p.viewer_orbit_deferred"):
    _, config, traffic = tiny_cell(m, w)
    run.CACHE = run.pathlib.Path(sys.argv[1])
    res = run.run_cell(config, traffic, run.cell_metrics(m, w, False), 99, 0.5, False, device="cpu", **TINY_FRAMES)
print(json.dumps({"modules": sorted({n.split(".")[0] for n in sys.modules}), "opened": opened}))
"""


def test_a_run_loads_no_jax_and_reads_no_jax_package_file(tmp_path):
    out = subprocess.run([sys.executable, "-c", RUN_TINY, str(tmp_path)], capture_output=True, text=True,
                         cwd=run.ROOT, check=True, timeout=600)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert not set(seen["modules"]) & {"jax", "jaxlib", "flax", "tpurast"}
    assert "tpurast_torch" in seen["modules"] and "portbench" in seen["modules"]
    root = str(run.ROOT)
    banned = [f"{root}/tpurast/", f"{root}/tools/", f"{root}/bench.py", f"{root}/chip_smoke.py"]
    assert not [p for p in seen["opened"] if any(p.startswith(b) for b in banned)]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, importlib\nfor n in ('tpurast_torch', 'tpurast', 'jax'):\n    sys.modules[n] = None\n"
            "import portbench.reference.render, portbench.reference.scene, portbench.reference.assets\n"
            "import portbench.check, portbench.yardstick, portbench.scenes\n"
            f"for k in {[p.stem for p in PLAIN if p.parent.name == 'recipes' and p.stem != '__init__']!r}:\n"
            "    importlib.import_module('portbench.recipes.' + k)\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0] in ('tpurast_torch', 'tpurast', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=run.ROOT, check=True)
    assert out.stdout.strip() == "['jax', 'tpurast', 'tpurast_torch']"  # only the blocked entries


@pytest.mark.parametrize("path", PLAIN, ids=[f"{p.parent.name}/{p.name}" for p in PLAIN])
def test_recipes_and_reference_name_no_program_module(path):
    """Not even inside a function, where importing them above would not reach."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names and not names & {"tpurast_torch", "tpurast", "jax", "jaxlib", "flax"}


def test_without_a_card_the_run_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "porsche_class_1080p.viewer_orbit", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=run.ROOT)
    assert out.returncode != 0 and out.stdout == "" and "CUDA" in out.stderr
