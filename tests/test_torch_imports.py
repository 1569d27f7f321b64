"""psnerf_torch stands alone: no module of it (nor chip_smoke.py, nor the
rank functions its data-parallel tests spawn) imports
jax, psnerf_tpu, imageio, cv2, yaml or matplotlib (the card's machine has
no imageio and no OpenCV, and PyYAML and matplotlib are not on record
there: the port reads and writes images with Pillow, parses its YAML
configs itself and draws its plots with Pillow), it imports on a
machine without triton or a GPU, and an entry point asked for CUDA where
there is none raises."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the port's tests import both packages)
import pytest
import torch

import psnerf_torch
from psnerf_torch.device import resolve_device

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "psnerf_torch"
FORBIDDEN = ("jax", "jaxlib", "psnerf_tpu", "imageio", "cv2", "yaml",
             "matplotlib")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests/torch_dist_workers.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_without_triton_jax_or_gpu():
    """Import every module in a fresh interpreter where importing jax,
    psnerf_tpu or triton raises and CUDA is hidden."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN + ('triton',)!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device()          # the default is the card
    from psnerf_torch.data.stage2 import load_stage2_data
    from psnerf_torch.runners.stage2 import Stage2Runner

    with pytest.raises(RuntimeError, match="is_available"):
        load_stage2_data(None, "", device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        Stage2Runner(None, str(tmp_path))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")
    assert psnerf_torch.__version__


def test_stage1_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from psnerf_torch.data.stage1 import load_stage1_data
    from psnerf_torch.runners.stage1 import Stage1Runner

    with pytest.raises(RuntimeError, match="is_available"):
        Stage1Runner(None, str(tmp_path))
    with pytest.raises(RuntimeError, match="is_available"):
        load_stage1_data(None)


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import numpy as np

    from psnerf_torch.mesh.refine import make_mask_carver, refine_mesh

    v = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        refine_mesh(lambda p: p[:, 0], v, np.asarray([[0, 1, 2]]), steps=1)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mask_carver(np.ones((1, 4, 4)), np.eye(4)[None],
                         np.eye(4)[None])


def test_parallel_entry_points_default_to_the_card(monkeypatch):
    """A mesh and a launch ask for CUDA unless told the CPU: without a
    card they raise before any process group or rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from psnerf_torch.parallel import launch, make_mesh

    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        launch(print, 2)
