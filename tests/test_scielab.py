"""S-CIELAB forward transform vs the oracle."""

import numpy as np
import jax.numpy as jnp

from hybridquantization.scielab import build_filters, srgb_to_scielab
from hybridquantization.scielab import transform as sct

from . import oracle


def test_srgb_to_scielab_vs_oracle(rng):
    img = rng.random((40, 56, 3), dtype=np.float32)
    filters = build_filters(72, 45.0)
    got = np.asarray(srgb_to_scielab(jnp.asarray(img), filters))

    ofilters, abs_k3, _ = oracle.build_filters(72, 45.0)
    want = oracle.srgb_to_scielab(img.astype(np.float64), ofilters, abs_k3)
    # f32 vs f64 over gamma + convs + cbrt on LAB-scale (~0-100) values
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_uniform_image_stays_uniform():
    """A constant image is spatially constant under filtering (reflection
    padding introduces no edge effects on constants), and its luminance gain
    is ~1 (sum-of-squared component sums ~ sum of weights ~ 1)."""
    filters = build_filters(72, 45.0)
    img = jnp.full((32, 32, 3), 0.5)
    lab = np.asarray(srgb_to_scielab(img, filters))
    for c in range(3):
        assert np.abs(lab[..., c] - lab[16, 16, c]).max() < 1e-3
    # gray 0.5: L of the filtered image ~ L of plain LAB (luminance gain ~1)
    from hybridquantization import colorspace as cs

    plain = np.asarray(cs.srgb_to_lab(jnp.full((3,), 0.5)))
    assert abs(lab[16, 16, 0] - plain[0]) < 1.5


def test_transform_shapes_and_finite(rng):
    filters = build_filters(96, 60.0)
    img = rng.random((25, 31, 3), dtype=np.float32)
    lab = np.asarray(srgb_to_scielab(jnp.asarray(img), filters))
    assert lab.shape == (25, 31, 3)
    assert np.isfinite(lab).all()


def test_stacked_kernels_layout():
    filters = build_filters(72, 45.0)
    kh = np.asarray(sct.stacked_kernels(filters, vertical=False))
    kv = np.asarray(sct.stacked_kernels(filters, vertical=True))
    assert kh.shape == (7, filters.taps)
    np.testing.assert_allclose(kh[:3], filters.k1.T)
    np.testing.assert_allclose(kh[3:6], filters.k2.T)
    np.testing.assert_allclose(kh[6], filters.k3)
    np.testing.assert_allclose(kv[6], filters.k3_abs)
    np.testing.assert_allclose(kv[:6], kh[:6])
