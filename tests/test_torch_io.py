"""Port parity: GaussianCloud's flat interchange and the PLY / binary
files, against the JAX package on the CPU.  The same cloud writes
byte-identical files on both sides, and each side loads the other's.

The port has the JAX package's numpy writer.  The JAX package's native
PLY writer takes libm's float logf where numpy takes its own log, and
the two differ in the last bit for some values, so the comparison turns
the native writer off and holds the port to the numpy writer's bytes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core import io as jio
from fresnel_tpu.core.gaussians import GaussianCloud as JCloud

from fresnel_tpu_torch.core import io as tio
from fresnel_tpu_torch.core.gaussians import GaussianCloud
from test_torch_threads import _few_threads  # noqa: F401


def _flat(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    return np.concatenate([
        rng.normal(size=(n, 3)), rng.uniform(1e-3, 0.3, (n, 3)),
        q / np.linalg.norm(q, axis=1, keepdims=True),
        rng.uniform(0, 1, (n, 3)), rng.uniform(0, 1, (n, 1))],
        axis=1).astype(np.float32)


def test_flat_roundtrip_matches_jax():
    flat = _flat(50, 0)
    c = GaussianCloud.from_flat(torch.from_numpy(flat))
    assert c.num_gaussians == 50
    assert c.opacities.shape == (50,) and c.rotations.shape == (50, 4)
    np.testing.assert_array_equal(
        c.to_flat().numpy(), np.asarray(JCloud.from_flat(jnp.asarray(flat)).to_flat()))


@pytest.mark.parametrize("ext", ["ply", "bin"])
@pytest.mark.parametrize("n", [1, 300])
def test_files_byte_identical_and_roundtrip(tmp_path, monkeypatch, ext, n):
    from fresnel_tpu import native
    monkeypatch.setattr(native, "save_ply", lambda path, flat: False)
    flat = _flat(n, n)
    save, load = {"ply": (tio.save_ply, tio.load_ply),
                  "bin": (tio.save_binary, tio.load_binary)}[ext]
    jsave, jload = {"ply": (jio.save_ply, jio.load_ply),
                    "bin": (jio.save_binary, jio.load_binary)}[ext]
    tp, jp = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    save(tp, GaussianCloud.from_flat(torch.from_numpy(flat)))
    jsave(jp, JCloud.from_flat(jnp.asarray(flat)))
    assert tp.read_bytes() == jp.read_bytes()

    back = load(tp)
    assert isinstance(back.positions, torch.Tensor)
    assert back.positions.dtype == torch.float32
    jback = np.asarray(jload(jp).to_flat())
    np.testing.assert_array_equal(back.to_flat().numpy(), jback)
    # PLY stores log scales, SH-DC colour and logit opacity: round trip
    # within float32 rounding of those maps (bin is exact).
    np.testing.assert_allclose(back.to_flat().numpy(), flat,
                               atol=0 if ext == "bin" else 2e-6)


def test_cloud_on_a_device_tensor_with_grad_saves(tmp_path):
    flat = torch.from_numpy(_flat(10, 3)).requires_grad_()
    tio.save_ply(tmp_path / "g.ply", GaussianCloud.from_flat(flat * 1.0))
    assert tio.load_ply(tmp_path / "g.ply").num_gaussians == 10
