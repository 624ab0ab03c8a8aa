"""Separable symmetric-padded convolution vs scipy."""

import numpy as np
from scipy.ndimage import correlate1d

from hybridquantization.ops.conv import (
    conv1d_symmetric,
    separable_conv2d_symmetric,
)


def _ref(x, kernels, axis):
    return np.stack(
        [correlate1d(x[c], kernels[c], axis=axis - 1, mode="reflect") for c in range(len(x))]
    )


def test_conv1d_horizontal(rng):
    x = rng.random((3, 17, 33), dtype=np.float32)
    k = rng.random((3, 7), dtype=np.float32)
    got = np.asarray(conv1d_symmetric(x, k, axis=2))
    np.testing.assert_allclose(got, _ref(x, k, 2), atol=1e-5)


def test_conv1d_vertical(rng):
    x = rng.random((3, 17, 33), dtype=np.float32)
    k = rng.random((3, 9), dtype=np.float32)
    got = np.asarray(conv1d_symmetric(x, k, axis=1))
    np.testing.assert_allclose(got, _ref(x, k, 1), atol=1e-5)


def test_reflection_semantics():
    """Half-sample symmetric: index -1 -> 0, -2 -> 1, W -> W-1
    (OptimizedConvolution.cl:21-27)."""
    x = np.arange(8, dtype=np.float32).reshape(1, 1, 8)
    k = np.array([[1.0, 0.0, 0.0]], dtype=np.float32)  # picks input[j-1]
    got = np.asarray(conv1d_symmetric(x, k, axis=2))[0, 0]
    want = np.array([0, 0, 1, 2, 3, 4, 5, 6], dtype=np.float32)
    np.testing.assert_allclose(got, want)

    k = np.array([[0.0, 0.0, 1.0]], dtype=np.float32)  # picks input[j+1]
    got = np.asarray(conv1d_symmetric(x, k, axis=2))[0, 0]
    want = np.array([1, 2, 3, 4, 5, 6, 7, 7], dtype=np.float32)
    np.testing.assert_allclose(got, want)


def test_separable(rng):
    x = rng.random((2, 21, 19), dtype=np.float32)
    k = rng.random((2, 5), dtype=np.float32)
    got = np.asarray(separable_conv2d_symmetric(x, k))
    want = _ref(_ref(x, k, 2), k, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_wide_filter_on_small_image(rng):
    """Filter wider than the image: mirroring must still match scipy."""
    x = rng.random((1, 6, 6), dtype=np.float32)
    k = rng.random((1, 9), dtype=np.float32)
    got = np.asarray(conv1d_symmetric(x, k, axis=2))
    np.testing.assert_allclose(got, _ref(x, k, 2), atol=1e-5)
