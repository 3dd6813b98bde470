"""The port stands alone: no JAX, Flax, optax or fresnel_tpu import, and
entry points refuse to run without CUDA unless the caller asks for the
CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fresnel_tpu"}
PORT_FILES = sorted((ROOT / "fresnel_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_forbidden_import(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil, fresnel_tpu_torch\n"
        "for m in pkgutil.walk_packages(fresnel_tpu_torch.__path__,\n"
        "                                'fresnel_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'fresnel_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


class TestDevice:
    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_resolve_device_defaults_to_cuda_and_raises(self):
        from fresnel_tpu_torch import resolve_device
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        assert resolve_device("cpu").type == "cpu"

    def test_build_models_raises_without_cuda(self):
        from fresnel_tpu_torch.pipeline import build_models
        with pytest.raises(RuntimeError, match="CUDA"):
            build_models(seed=0)

    def test_image_to_3dgs_raises_without_cuda(self):
        from fresnel_tpu_torch.pipeline import image_to_3dgs
        with pytest.raises(RuntimeError, match="CUDA"):
            image_to_3dgs(None, torch.zeros(8, 8, 3))

    def test_fit_scene_raises_without_cuda(self):
        import numpy as np
        from fresnel_tpu_torch.train.fit_teacher import fit_scene
        with pytest.raises(RuntimeError, match="CUDA"):
            fit_scene(np.zeros((3, 16, 16), np.float32),
                      np.zeros((16, 16), np.float32), steps=1, grid=2, K=1,
                      res=16)

    def test_refine_raises_without_cuda(self):
        import numpy as np
        from fresnel_tpu_torch.cli import refine
        with pytest.raises(RuntimeError, match="CUDA"):
            refine(np.zeros((16, 16, 3), np.float32), steps=1)

    def test_trainer_and_datasets_raise_without_cuda(self):
        from fresnel_tpu_torch.data.dataset import SyntheticGaussianDataset
        from fresnel_tpu_torch.train.config import TrainingConfig
        from fresnel_tpu_torch.train.harness import Trainer
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(TrainingConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            SyntheticGaussianDataset(n_samples=1, image_size=16)

    def test_render_and_orbit_raise_without_cuda(self):
        from fresnel_tpu_torch.cli import orbit, render
        from fresnel_tpu_torch.core.gaussians import GaussianCloud
        cloud = GaussianCloud.test_cloud(4)
        with pytest.raises(RuntimeError, match="CUDA"):
            render(cloud, size=16)
        with pytest.raises(RuntimeError, match="CUDA"):
            orbit(cloud, views=1, size=16)
