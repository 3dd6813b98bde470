"""The port stands alone: no JAX, Flax, optax or fresnel_tpu import, nor
msgpack, ml_dtypes, safetensors or transformers (packages the card's
machine may lack: the port reads Flax and safetensors files with its own
readers), and entry points refuse to run without CUDA unless the caller asks
for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fresnel_tpu", "msgpack",
             "ml_dtypes", "safetensors", "transformers"}
PORT_FILES = sorted((ROOT / "fresnel_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# The modules of ROADMAP Queue 1, item 10 (the rest of train/, data/ and
# utils/): each is one of PORT_FILES, so the import checks cover it.
ITEM10 = ("utils/image.py", "utils/profiling.py", "train/thin_ckpt.py",
          "train/reconstruct_sidecar.py", "data/preprocess.py",
          "data/streaming.py", "data/depth_dataset.py",
          "train/train_depth.py", "train/auto_tune.py",
          "train/hyperparam_search.py")
# The modules of ROADMAP Queue 1, item 9 (Fresnel v2 distillation).
ITEM9 = ("models/slat.py", "data/trellis.py", "train/train_direct_decoder.py",
         "weights.py")
# The modules of ROADMAP Queue 1, item 11 (`smoke`, the bridges, export).
ITEM11 = ("cli.py", "inference/bridges.py", "export/__init__.py",
          "export/export_decoder.py")
# The modules of ROADMAP Queue 1, item 12 (parallel/ on torch.distributed).
ITEM12 = ("parallel/__init__.py", "parallel/mesh.py", "parallel/tp.py",
          "parallel/render.py", "parallel/launch.py", "parallel/jobs.py")


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


@pytest.mark.parametrize("rel", ITEM10)
def test_item10_module_checked(rel):
    path = ROOT / "fresnel_tpu_torch" / rel
    assert path in PORT_FILES
    assert not _imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("rel", ITEM9)
def test_item9_module_checked(rel):
    path = ROOT / "fresnel_tpu_torch" / rel
    assert path in PORT_FILES
    assert not _imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("rel", ITEM11)
def test_item11_module_checked(rel):
    path = ROOT / "fresnel_tpu_torch" / rel
    assert path in PORT_FILES
    assert not _imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("rel", ITEM12)
def test_item12_module_checked(rel):
    path = ROOT / "fresnel_tpu_torch" / rel
    assert path in PORT_FILES
    assert not _imported_roots(path) & FORBIDDEN


def test_parallel_exports_jax_all():
    """`fresnel_tpu_torch.parallel` exports what the JAX package's does,
    and `parallel.render` its three sharded renders."""
    import fresnel_tpu_torch.parallel as tpar
    from fresnel_tpu_torch.parallel import render as trender

    jax_init = (ROOT / "fresnel_tpu" / "parallel" / "__init__.py")
    tree = ast.parse(jax_init.read_text())
    want = next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign)
                and n.targets[0].id == "__all__")
    assert tpar.__all__ == want
    for name in want:
        assert callable(getattr(tpar, name))
    for name in ("render_batch_sharded", "render_gaussian_sharded",
                 "render_pixel_sharded"):
        assert callable(getattr(trender, name))


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil, fresnel_tpu_torch\n"
        "for m in pkgutil.walk_packages(fresnel_tpu_torch.__path__,\n"
        "                                'fresnel_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'fresnel_tpu',\n"
        "        'msgpack', 'ml_dtypes', 'safetensors', 'transformers')]\n"
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

    def test_trainer_and_datasets_raise_without_cuda(self, tmp_path):
        from PIL import Image
        from fresnel_tpu_torch import cli
        from fresnel_tpu_torch.data.dataset import SyntheticGaussianDataset
        from fresnel_tpu_torch.train.config import TrainingConfig
        from fresnel_tpu_torch.train.harness import Trainer
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(TrainingConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            SyntheticGaussianDataset(n_samples=1, image_size=16)
        img = tmp_path / "img.png"
        Image.new("RGB", (16, 16)).save(img)
        ckpt = str(ROOT / "results" / "exp2_model.msgpack")
        for argv in (["infer", str(img), str(tmp_path / "o.ply")],
                     ["infer", str(img), str(tmp_path / "o.ply"),
                      "--checkpoint", ckpt],
                     ["eval", ckpt, "--synthetic", "--max_images", "1"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main(argv)

    @pytest.mark.parametrize("entry", [
        "data.preprocess", "data.streaming", "data.depth_dataset",
        "train.train_depth", "train.auto_tune", "train.hyperparam_search"])
    def test_item10_entries_raise_without_cuda(self, entry, tmp_path):
        import importlib
        mod = importlib.import_module(f"fresnel_tpu_torch.{entry}")
        with pytest.raises(RuntimeError, match="CUDA"):
            if entry == "data.streaming":
                mod.StreamingImageDataset(str(tmp_path))
            elif entry.startswith("data."):
                mod.main([str(tmp_path)])
            else:
                mod.main(["--synthetic", "--output_dir", str(tmp_path)])

    def test_cvs_raises_without_cuda(self, tmp_path):
        import numpy as np
        from fresnel_tpu_torch.inference import cvs_multiview
        from fresnel_tpu_torch.train import train_cvs
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cvs.CVSTrainer(train_cvs.CVSTrainConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cvs.GaussianBootstrapDataset(n_scenes=1, image_size=16)
        for cls in (train_cvs.TeacherMultiviewDataset,
                    train_cvs.GTMultiviewDataset):
            with pytest.raises(RuntimeError, match="CUDA"):
                cls(str(tmp_path), image_size=16)
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cvs.main(["--synthetic", "--epochs", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            cvs_multiview.optimize_3dgs(np.zeros((1, 3, 16, 16), np.float32),
                                        [(0.0, 0.0)], 16, steps=1)
        trainer = train_cvs.CVSTrainer(
            train_cvs.CVSTrainConfig(image_size=16, base_channels=32),
            device="cpu")
        ckpt = tmp_path / "cvs.pt"
        trainer.save_checkpoint(ckpt, trainer.init_state(), 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            cvs_multiview.main([str(tmp_path / "x.png"), "--checkpoint",
                                str(ckpt)])

    def test_v2_raises_without_cuda(self, tmp_path):
        from fresnel_tpu_torch.data.trellis import SyntheticTrellisDataset
        from fresnel_tpu_torch.train import train_direct_decoder as v2
        with pytest.raises(RuntimeError, match="CUDA"):
            v2.V2Trainer(v2.V2Config())
        for argv in (["--synthetic", "--epochs", "1"],
                     ["--data_dir", str(tmp_path), "--epochs", "1"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                v2.main(argv + ["--output_dir", str(tmp_path / "o")])
        assert not (tmp_path / "o").exists()
        # The datasets are host numpy: they need no device.
        assert len(SyntheticTrellisDataset(n_samples=1, feature_dim=4,
                                           num_patches=4)) == 1

    def test_item11_entries_raise_without_cuda(self, tmp_path):
        from PIL import Image
        from fresnel_tpu_torch.export import export_decoder
        from fresnel_tpu_torch.inference import bridges
        img = tmp_path / "img.png"
        Image.new("RGB", (16, 16)).save(img)
        ckpt = str(ROOT / "results" / "exp2_model.msgpack")
        for argv in (["dinov2", str(img), str(tmp_path / "f.bin")],
                     ["depth", str(img), str(tmp_path / "d.bin")],
                     ["test_novel_views", str(img), str(tmp_path / "v")]):
            with pytest.raises(RuntimeError, match="CUDA"):
                bridges.main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            export_decoder.main([ckpt, "--onnx", str(tmp_path / "m.onnx")])
        assert sorted(p.name for p in tmp_path.iterdir()) == ["img.png"]

    def test_render_and_orbit_raise_without_cuda(self):
        from fresnel_tpu_torch.cli import orbit, render
        from fresnel_tpu_torch.core.gaussians import GaussianCloud
        cloud = GaussianCloud.test_cloud(4)
        with pytest.raises(RuntimeError, match="CUDA"):
            render(cloud, size=16)
        with pytest.raises(RuntimeError, match="CUDA"):
            orbit(cloud, views=1, size=16)

    def test_saag_view_and_experiments_raise_without_cuda(self, tmp_path):
        import numpy as np
        from PIL import Image
        from fresnel_tpu_torch import cli
        from fresnel_tpu_torch.core import io as gio
        from fresnel_tpu_torch.core.gaussians import GaussianCloud
        from fresnel_tpu_torch.train.config import TrainingConfig
        from fresnel_tpu_torch.train.harness import Trainer
        from fresnel_tpu_torch.viewer import serve
        img = tmp_path / "img.png"
        Image.new("RGB", (16, 16)).save(img)
        ply = tmp_path / "c.ply"
        gio.save_ply(ply, GaussianCloud.test_cloud(4))
        for argv in (["infer", str(img), str(tmp_path / "o.ply"), "--saag"],
                     ["infer", str(img), str(tmp_path / "o.ply"),
                      "--no_model", "--html", str(tmp_path / "o.html")],
                     ["view", str(ply), str(tmp_path / "v.html")],
                     ["view", str(img), "--serve", "--port", "0"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.saag_infer(np.zeros((16, 16, 3), np.float32))
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.ReprocessSession(np.zeros((16, 16, 3), np.float32),
                                   np.zeros((16, 16), np.float32), grid=16)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.serve_image(str(img), port=0, grid=16)
        for exp in (1, 3, 5):
            with pytest.raises(RuntimeError, match="CUDA"):
                Trainer(TrainingConfig(experiment=exp))
        assert not (tmp_path / "o.ply").exists()
        assert not (tmp_path / "v.html").exists()
