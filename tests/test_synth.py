"""Tests for the deterministic content generators (hybridquantization.synth).

The natural-statistics image is a measurement axis (bench + parity), so
its defining properties are pinned: determinism, range, spatial
coherence (the thing uniform-random content lacks), a decaying power
spectrum, and channel correlation.
"""

from __future__ import annotations

import numpy as np

from hybridquantization import synth


def test_natural_image_deterministic():
    a = synth.natural_image(64, 96, seed=3)
    b = synth.natural_image(64, 96, seed=3)
    np.testing.assert_array_equal(a, b)
    c = synth.natural_image(64, 96, seed=4)
    assert np.abs(a - c).max() > 1e-3


def test_natural_image_shape_range():
    img = synth.natural_image(50, 70, seed=0)
    assert img.shape == (50, 70, 3) and img.dtype == np.float32
    assert img.min() >= 0.0 and img.max() <= 1.0
    # fills a substantial part of [0,1], not a flat gray field
    assert img.max() - img.min() > 0.5


def test_natural_image_spatially_coherent():
    img = synth.natural_image(256, 256, seed=1).astype(np.float64)
    rnd = np.random.default_rng(0).random((256, 256, 3))

    def neighbor_corr(x):
        a = x[:, :-1].ravel()
        b = x[:, 1:].ravel()
        return np.corrcoef(a, b)[0, 1]

    assert neighbor_corr(img) > 0.95  # coherent content
    assert abs(neighbor_corr(rnd)) < 0.05  # the adversarial bench class


def test_natural_image_power_spectrum_decays():
    img = synth.natural_image(256, 256, seed=2).astype(np.float64)
    lum = img.mean(axis=-1)
    f = np.fft.fftshift(np.abs(np.fft.fft2(lum - lum.mean())) ** 2)
    c = 128
    yy, xx = np.mgrid[0:256, 0:256]
    r = np.hypot(yy - c, xx - c)
    low = f[(r >= 2) & (r < 8)].mean()
    mid = f[(r >= 16) & (r < 32)].mean()
    high = f[(r >= 64) & (r < 120)].mean()
    assert low > 10 * mid > 10 * high  # ~1/f^2 power falloff


def test_natural_image_channels_correlated():
    img = synth.natural_image(128, 128, seed=5).reshape(-1, 3).astype(np.float64)
    cc = np.corrcoef(img.T)
    assert cc[0, 1] > 0.7 and cc[1, 2] > 0.7  # luminance-dominant mixing


def test_smooth_test_image_matches_parity_tool():
    """tools/parity_check.make_test_image must stay bit-identical to
    synth.smooth_test_image — the committed JSONL evidence depends on it."""
    import os
    import sys

    sys.path.insert(
        0,
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"
        ),
    )
    from parity_check import make_test_image

    a = make_test_image(96, np.random.default_rng(0))
    b = synth.smooth_test_image(96, np.random.default_rng(0))
    np.testing.assert_array_equal(a, b)
