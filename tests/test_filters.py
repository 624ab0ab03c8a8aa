"""Filter-bank construction vs the oracle and reference invariants."""

import numpy as np
import pytest

from hybridquantization.scielab import filters as F

from . import oracle


def test_gauss_normalized():
    for hw, width in [(12.1, 241), (54.45, 241), (5.0, 21)]:
        g = F.gauss(hw, width)
        assert g.shape == (width,)
        assert float(g.sum()) == pytest.approx(1.0, abs=1e-6)
        np.testing.assert_allclose(g, g[::-1], rtol=1e-6)  # symmetric


def test_samples_per_degree_default():
    # dpi=72, 45 cm: raw 22 spd -> uprate 11 -> 242 (ScielabProcessor.java:79-88)
    spd, uprate = F.samples_per_degree(72, 45.0)
    assert (spd, uprate) == (242, 11)


def test_samples_per_degree_high_res():
    # 800 dpi at 45 cm: 248 raw samples/degree >= the 224 floor -> no upsampling
    spd, uprate = F.samples_per_degree(800, 45.0)
    assert uprate == 1
    assert spd == 248


def test_default_filter_shape():
    f = F.build_filters(72, 45.0)
    # After decimation: 2*(120//11)+1 = 21 taps; halfWidth 10 matches the
    # reference's filters4[0].length/8 (ImageManipulation.java:300).
    assert f.taps == 21
    assert f.half_width == 10
    assert f.k1.shape == (21, 3)
    assert f.k2.shape == (21, 3)
    assert f.k3.shape == (21,)
    np.testing.assert_allclose(f.k3_abs, np.abs(f.k3), rtol=0)


@pytest.mark.parametrize("dpi,dist", [(72, 45.0), (96, 60.0), (300, 45.0)])
def test_filters_vs_oracle(dpi, dist):
    got = F.build_filters(dpi, dist)
    ofilters, abs_k3, spd = oracle.build_filters(dpi, dist)
    assert got.samp_per_deg == spd
    np.testing.assert_allclose(got.k1[:, 0], ofilters[0][0], atol=1e-7)
    np.testing.assert_allclose(got.k1[:, 1], ofilters[1][0], atol=1e-7)
    np.testing.assert_allclose(got.k1[:, 2], ofilters[2][0], atol=1e-7)
    np.testing.assert_allclose(got.k2[:, 0], ofilters[0][1], atol=1e-7)
    np.testing.assert_allclose(got.k2[:, 1], ofilters[1][1], atol=1e-7)
    np.testing.assert_allclose(got.k2[:, 2], ofilters[2][1], atol=1e-7)
    np.testing.assert_allclose(got.k3, ofilters[0][2], atol=1e-7)
    np.testing.assert_allclose(got.k3_abs, abs_k3, atol=1e-7)


def test_weight_preservation():
    """The h x v outer product of each component carries its weight w.

    At high sampling rates (no decimation) sum(k)^2 == w exactly because each
    Gaussian sums to 1 before the sqrt(|w|) scaling (ScielabProcessor.java:113-117).
    """
    f = F.build_filters(300, 45.0)
    for c in range(3):
        for j, arr in (
            [(0, f.k1[:, c]), (1, f.k2[:, c])] + ([(2, f.k3)] if c == 0 else [])
        ):
            w = F.WEIGHTS[c][j]
            s = float(arr.sum())
            assert np.sign(s) == np.sign(w)
            assert s * abs(s) == pytest.approx(w, rel=5e-3)
