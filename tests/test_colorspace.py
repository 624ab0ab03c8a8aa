"""Color-space math vs the NumPy oracle and closed-form scalar values."""

import numpy as np
import jax.numpy as jnp
import pytest

from hybridquantization import colorspace as cs

from . import oracle


def test_rgb2opp_matches_opencl_constants():
    # OptimizedConvolution.cl:171 (printed to 6 significant digits)
    expected = np.array(
        [
            [0.266413, 0.603167, 0.00113333],
            [-0.124957, 0.0375879, -0.133381],
            [-0.0803345, -0.331467, 0.449132],
        ]
    )
    np.testing.assert_allclose(cs.M_RGB2OPP, expected, rtol=2e-4, atol=2e-5)


def test_gamma_round_trip(rng):
    x = rng.random((64, 3), dtype=np.float32)
    back = cs.linear_to_srgb(cs.srgb_to_linear(x))
    np.testing.assert_allclose(back, x, atol=2e-6)


def test_gamma_branch_points():
    # threshold continuity at 0.04045 / 0.0031308
    lo, hi = 0.04045 - 1e-6, 0.04045 + 1e-6
    assert abs(float(cs.srgb_to_linear(lo)) - float(cs.srgb_to_linear(hi))) < 1e-5
    lo, hi = 0.0031308 - 1e-7, 0.0031308 + 1e-7
    assert abs(float(cs.linear_to_srgb(lo)) - float(cs.linear_to_srgb(hi))) < 1e-5


def test_srgb_xyz_round_trip(rng):
    x = rng.random((128, 3), dtype=np.float32)
    np.testing.assert_allclose(cs.xyz_to_srgb(cs.srgb_to_xyz(x)), x, atol=1e-4)


def test_lab_round_trip(rng):
    xyz = rng.random((128, 3), dtype=np.float32) * 1.1
    np.testing.assert_allclose(
        cs.lab_to_xyz(cs.xyz_to_lab(xyz)), xyz, rtol=1e-4, atol=1e-5
    )


def test_conversions_vs_oracle(rng):
    x = rng.random((256, 3), dtype=np.float32)
    np.testing.assert_allclose(cs.srgb_to_xyz(x), oracle.srgb_to_xyz(x), atol=1e-5)
    np.testing.assert_allclose(
        cs.xyz_to_opp(cs.srgb_to_xyz(x)),
        oracle.xyz_to_opp(oracle.srgb_to_xyz(x)),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        cs.srgb_to_opp(x), oracle.xyz_to_opp(oracle.srgb_to_xyz(x)), atol=1e-5
    )
    opp = np.asarray(oracle.xyz_to_opp(oracle.srgb_to_xyz(x)), np.float32)
    np.testing.assert_allclose(
        cs.opp_to_lab(opp), oracle.opp_to_lab(opp), atol=2e-3
    )


def test_lab_f_branch_continuity():
    d3 = float(cs.LAB_DELTA3)
    assert abs(float(cs.lab_f(d3 * (1 - 1e-6))) - float(cs.lab_f(d3 * (1 + 1e-6)))) < 1e-5


def test_delta_e76(rng):
    a = rng.random((64, 3), dtype=np.float32) * 100
    b = rng.random((64, 3), dtype=np.float32) * 100
    np.testing.assert_allclose(
        cs.delta_e76(a, b), np.linalg.norm(a - b, axis=-1), rtol=1e-5
    )


def test_delta_e94_reference_formula(rng):
    # scalar transcription of OptimizedConvolution.cl:218-226
    a = rng.random((32, 3)) * np.array([100, 120, 120]) - np.array([0, 60, 60])
    b = a + rng.normal(size=a.shape) * 5
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    got = np.asarray(cs.delta_e94(a32, b32))
    for i in range(len(a)):
        L1, a1, b1 = a[i]
        L2, a2, b2 = b[i]
        dL = L1 - L2
        c1 = np.hypot(a1, b1)
        dC = c1 - np.hypot(a2, b2)
        dH2 = max((a1 - a2) ** 2 + (b1 - b2) ** 2 - dC**2, 0.0)
        want = np.sqrt(
            dL**2 + (dC / (1 + 0.045 * c1)) ** 2 + (np.sqrt(dH2) / (1 + 0.015 * c1)) ** 2
        )
        assert got[i] == pytest.approx(want, rel=1e-4)


def test_delta_e2000_sharma_pairs():
    # Sharma, Wu & Dalal (2005) test data.
    cases = [
        ((50.0, 2.6772, -79.7751), (50.0, 0.0, -82.7485), 2.0425),
        ((50.0, 2.8361, -74.0200), (50.0, 0.0, -82.7485), 3.4412),
        ((60.2574, -34.0099, 36.2677), (60.4626, -34.1751, 39.4387), 1.2644),
        ((50.0, 2.5, 0.0), (73.0, 25.0, -18.0), 27.1492),
        ((50.0, 2.5, 0.0), (50.0, 3.2592, 0.3350), 1.0000),
    ]
    for lab1, lab2, want in cases:
        got = float(cs.delta_e2000(jnp.array(lab1), jnp.array(lab2)))
        assert got == pytest.approx(want, abs=2e-3)


def test_delta_e_dispatch():
    a = jnp.zeros((3,))
    with pytest.raises(ValueError):
        cs.delta_e(a, a, "NOPE")
    assert float(cs.delta_e(a, a, "CIE76")) == 0.0
