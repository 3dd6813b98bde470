"""Port parity: `data.raytrace_corpus` (corpus_v2, the raytraced multi-view
corpus) against the JAX package's copy, on the CPU: the same files with
the same bytes (frontal PNG, `_depth.bin`, `_views.npz` with `images`
and `azimuths_deg`) for 2 scenes at 64^2, written whole and sharded by
`main --start / --stride`, and the same arrays from
`render_scene_views`."""

import filecmp
import os

import numpy as np

from fresnel_tpu.data import raytrace_corpus as jrc

from fresnel_tpu_torch.data import raytrace_corpus as trc
from test_torch_threads import _few_threads  # noqa: F401

SEED, N, SIZE = 21, 2, 64


def test_corpus_bytes_match_jax(tmp_path):
    jrc.generate_corpus(str(tmp_path / "j"), n_images=N, image_size=SIZE,
                        seed=SEED)
    for start in range(2):          # two shards, as parallel processes run
        trc.main([str(tmp_path / "t"), "--n_images", str(N), "--image_size",
                  str(SIZE), "--seed", str(SEED), "--start", str(start),
                  "--stride", "2"])
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert len(names) == 3 * N
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "j", tmp_path / "t", names, shallow=False)
    assert match == names and not mismatch and not errors
    with np.load(tmp_path / "t" / "scene_0001_views.npz") as z:
        assert z["images"].shape == (8, SIZE, SIZE, 3)
        assert z["images"].dtype == np.uint8
        assert z["azimuths_deg"].tolist() == list(trc.DEFAULT_AZIMUTHS_DEG)


def test_scene_views_match_jax():
    _, jv, jd = jrc.render_scene_views(SEED, 5, 32)
    _, tv, td = trc.render_scene_views(SEED, 5, 32)
    assert jv.tobytes() == tv.tobytes() and jd.tobytes() == td.tobytes()
