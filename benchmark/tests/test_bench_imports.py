"""The benchmark measures psnerf_torch alone: no module the harness or
the reference imports is jax, jaxlib, flax or the JAX package (compared
by whole top-level names: psnerf_torch begins with the JAX package's
letters), and the plain reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "psnerf_tpu"}


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    roots = imported_roots(path)
    assert "psnerf_torch" not in roots
    assert roots <= {"__future__", "benchmark", "contextlib", "math",
                     "numpy", "torch", "json", "os", "PIL"}


def test_reference_loads_without_the_program():
    """In a fresh interpreter where importing psnerf_torch (or JAX) raises,
    the reference and the scene generator still import."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('psnerf_torch', 'psnerf_tpu',"
        " 'jax', 'jaxlib', 'flax'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import benchmark.reference.stage1, benchmark.reference.stage2\n"
        "import benchmark.reference.compare, benchmark.scene.synthetic\n"
        "import benchmark.work\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_a_run_loads_no_jax():
    """A whole toy run in a fresh interpreter leaves no JAX module in
    sys.modules."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark.run import run_cell\n"
        "from benchmark import harness\n"
        "from toy import toy\n"
        "res, checks = run_cell('s2_train_bear', 5, 0.3, 0, device='cpu',"
        " overrides=toy('s2_train_bear'))\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "[]"
