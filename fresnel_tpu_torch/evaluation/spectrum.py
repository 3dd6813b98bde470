"""Radial spectral-power metrics: WHERE (in spatial frequency) a render
loses texture vs its target.

A copy of fresnel_tpu/evaluation/spectrum.py (numpy), kept in the port so
that it imports nothing of the JAX package.

Motivated by the T-038 adjudication (experiments/README.md): pixel
metrics (SSIM/PSNR) say *that* texture is missing, the per-octave
render/target power ratio says *at which scale* — e.g. the flagship
decoder reproduces ~80% of spectral power at 2-3 cycles/image but <10%
above the 37x37 patch grid's Nyquist (~18.5 cycles/image).

The reference has no spectral evaluation; its frequency-domain LOSS
(reference: scripts/training/train_gaussian_decoder.py:430-520) is the
training-side analogue.  Host-side numpy on purpose: eval-time tooling,
not a training path.
"""
from typing import Tuple

import numpy as np

LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def radial_power(img: np.ndarray, n_bands: int = 8
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Luminance radial power spectrum in octave-spaced bands.

    img: (H, W, 3) or (3, H, W) or (H, W), values in [0, 1].
    Returns (band_edges, band_power): power[i] = total |F|^2 in
    [edges[i], edges[i+1]) cycles/image, DC excluded."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        if img.shape[0] == 3:                 # CHW -> HWC
            img = np.transpose(img, (1, 2, 0))
        lum = img @ LUMA
    else:
        lum = img
    f = np.fft.fftshift(np.fft.fft2(lum - lum.mean()))
    p = np.abs(f) ** 2
    h, w = lum.shape
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot(yy - h / 2, xx - w / 2)
    edges = np.geomspace(2.0, min(h, w) / 2.0, n_bands + 1)
    power = np.array([p[(r >= lo) & (r < hi)].sum()
                      for lo, hi in zip(edges[:-1], edges[1:])])
    return edges, power


def band_power_ratio(render: np.ndarray, target: np.ndarray,
                     n_bands: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Per-band render/target power ratio (1.0 = texture fully
    reproduced at that scale).  Shapes as radial_power."""
    edges, pr = radial_power(render, n_bands)
    _, pt = radial_power(target, n_bands)
    return edges, pr / np.maximum(pt, 1e-12)


def band_labels(edges: np.ndarray):
    return [f"{lo:.1f}-{hi:.1f}" for lo, hi in zip(edges[:-1], edges[1:])]
