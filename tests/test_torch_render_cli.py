"""Port parity: `render_views`, and the `render` and `orbit` CLI functions.

Images are held against the JAX package's at atol 2e-5, the compositor's
tolerance in test_torch_tile.py, at 64^2 on the CPU; the cloud is
anisotropic (no cancelling radius, see test_torch_binning.py).  PNG files
are compared after the 8-bit truncation both CLIs apply, within one count.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu import cli as jcli
from fresnel_tpu.core import io as jio
from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.core.gaussians import GaussianCloud as JCloud
from fresnel_tpu.evaluation import novel_view_eval as jnv
from fresnel_tpu.render import tile as jt

from fresnel_tpu_torch import cli as tcli
from fresnel_tpu_torch.core import io as tio
from fresnel_tpu_torch.core.gaussians import GaussianCloud as TCloud
from fresnel_tpu_torch.evaluation import novel_view_eval as tnv

FIELDS = ("positions", "scales", "rotations", "colors", "opacities")
N, SIZE = 400, 64


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        positions=(rng.normal(size=(N, 3)) * 0.35).astype(np.float32),
        scales=rng.uniform(0.02, 0.12, size=(N, 3)).astype(np.float32),
        rotations=rng.normal(size=(N, 4)).astype(np.float32),
        colors=rng.uniform(size=(N, 3)).astype(np.float32),
        opacities=rng.uniform(0.1, 1.0, size=N).astype(np.float32))


def _tcloud(seed=0):
    return TCloud(**{k: torch.from_numpy(v) for k, v in _arrays(seed).items()})


def _jax_render(arrs, el, az, distance, size, max_per_tile):
    cam = JCamera.from_pose(np.radians(el), np.radians(az), size,
                            distance=distance)
    return np.asarray(jt.render_tiled(
        *[jnp.asarray(arrs[k]) for k in FIELDS], cam,
        config=jt.TileRendererConfig(max_per_tile=max_per_tile,
                                     backend="xla")))


class TestRenderViews:
    def test_matches_jax(self):
        arrs = _arrays()
        az = (0.0, 120.0, 250.0)
        ref = jnv.render_views({k: jnp.asarray(v) for k, v in arrs.items()},
                               render_size=SIZE, azimuths_deg=az,
                               elevation_deg=20.0, distance=1.8)
        out = tnv.render_views({k: torch.from_numpy(v)
                                for k, v in arrs.items()},
                               render_size=SIZE, azimuths_deg=az,
                               elevation_deg=20.0, distance=1.8)
        assert out.shape == (3, 3, SIZE, SIZE)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
        assert out.max() > 0.1, "the views should show the cloud"

    def test_defaults_are_the_jax_defaults(self):
        assert tnv.DEFAULT_AZIMUTHS_DEG == jnv.DEFAULT_AZIMUTHS_DEG
        out = tnv.render_views({k: torch.from_numpy(v)
                                for k, v in _arrays().items()},
                               render_size=32)
        assert out.shape == (8, 3, 32, 32)


class TestRenderFunction:
    @pytest.mark.parametrize("el,az,distance,mpt", [
        (0.0, 0.0, 2.0, 512), (25.0, 140.0, 1.6, 64), (90.0, 0.0, 2.0, 512)])
    def test_matches_jax(self, el, az, distance, mpt):
        img = tcli.render(_tcloud(), elevation=el, azimuth=az,
                          distance=distance, size=SIZE, max_per_tile=mpt,
                          device="cpu")
        assert img.shape == (3, SIZE, SIZE) and not img.requires_grad
        ref = _jax_render(_arrays(), el, az, distance, SIZE, mpt)
        np.testing.assert_allclose(img.numpy(), ref, atol=2e-5)

    def test_orbit_matches_jax(self):
        az, views = tcli.orbit(_tcloud(1), views=3, elevation=10.0,
                               distance=2.2, size=SIZE, device="cpu")
        np.testing.assert_array_equal(az, [0.0, 120.0, 240.0])
        assert views.shape == (3, 3, SIZE, SIZE)
        for a, v in zip(az, views):
            # orbit renders at render_views' max_per_tile of 256.
            ref = _jax_render(_arrays(1), 10.0, a, 2.2, SIZE, 256)
            np.testing.assert_allclose(v.numpy(), ref, atol=2e-5)

    def test_no_grad_even_for_leaf_inputs(self):
        cloud = _tcloud()
        cloud = TCloud(**{k: getattr(cloud, k).clone().requires_grad_()
                          for k in FIELDS})
        img = tcli.render(cloud, size=32, device="cpu")
        assert not img.requires_grad


class TestCommands:
    def _png(self, path):
        from PIL import Image

        return np.asarray(Image.open(path))

    @pytest.mark.parametrize("suffix", [".ply", ".bin"])
    def test_render_command(self, tmp_path, suffix):
        """A cloud file written by the JAX package, rendered by both CLIs."""
        cloud_path = str(tmp_path / f"cloud{suffix}")
        jcloud = JCloud(**{k: jnp.asarray(v) for k, v in _arrays(2).items()})
        (jio.save_ply if suffix == ".ply" else jio.save_binary)(
            cloud_path, jcloud)
        flags = ["--size", str(SIZE), "--azimuth", "30", "--elevation", "15",
                 "--distance", "1.9", "--max_per_tile", "128"]
        assert tcli.main(["render", cloud_path, str(tmp_path / "t.png"),
                          "--device", "cpu", *flags]) == 0
        assert jcli.main(["render", cloud_path, str(tmp_path / "j.png"),
                          *flags]) == 0
        t, j = self._png(tmp_path / "t.png"), self._png(tmp_path / "j.png")
        assert t.shape == (SIZE, SIZE, 3) and t.dtype == np.uint8
        assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
        assert t.max() > 25

    def test_orbit_command(self, tmp_path):
        cloud_path = str(tmp_path / "cloud.bin")
        tio.save_binary(cloud_path, _tcloud(3))
        out_dir = tmp_path / "orbit"
        assert tcli.main(["orbit", cloud_path, str(out_dir), "--views", "4",
                          "--size", "32", "--device", "cpu"]) == 0
        assert sorted(p.name for p in out_dir.iterdir()) == [
            "view_az000.png", "view_az090.png", "view_az180.png",
            "view_az270.png"]
        assert self._png(out_dir / "view_az090.png").shape == (32, 32, 3)

    @pytest.mark.parametrize("cmd,argv", [
        ("render", ["render", "c.ply", "o.png"]),
        ("orbit", ["orbit", "c.ply", "out"])])
    def test_parser_defaults_are_the_jax_defaults(self, cmd, argv):
        t = vars(tcli.build_parser().parse_args(argv))
        j = vars(jcli.build_parser().parse_args(argv))
        assert t.pop("device") == "cuda" and t.pop("cmd") == cmd
        assert j.pop("command") == cmd
        assert t == j
