"""Image I/O and layout converters."""

import numpy as np
import pytest

from hybridquantization import io as hio


def test_ppm_round_trip(tmp_path, rng):
    img = rng.random((33, 47, 3)).astype(np.float32)
    p = str(tmp_path / "t.ppm")
    hio.save_image(p, img)
    back = hio.load_image(p)
    # 8-bit quantized round trip
    np.testing.assert_allclose(back, np.round(img * 255) / 255, atol=1 / 255)


def test_ppm_comments_and_p5(tmp_path):
    p = str(tmp_path / "c.ppm")
    with open(p, "wb") as f:
        f.write(b"P6\n# a comment\n2 2\n# another\n255\n" + bytes(range(12)))
    img = hio.load_image(p)
    assert img.shape == (2, 2, 3)
    assert img[0, 0, 0] == 0.0
    p5 = str(tmp_path / "g.pgm")
    with open(p5, "wb") as f:
        f.write(b"P5\n2 2\n255\n" + bytes([0, 85, 170, 255]))
    img = hio.load_image(p5)
    assert img.shape == (2, 2, 3)
    np.testing.assert_array_equal(img[..., 0], img[..., 1])
    assert img[1, 1, 0] == 1.0


def test_png_round_trip(tmp_path, rng):
    pytest.importorskip("PIL")
    img = rng.random((20, 30, 3)).astype(np.float32)
    p = str(tmp_path / "t.png")
    hio.save_image(p, img)
    back = hio.load_image(p)
    np.testing.assert_allclose(back, np.round(img * 255) / 255, atol=1 / 255)


def test_save_round_half_up(tmp_path):
    """UBYTE conversion parity (HybridQuantization.java:122): v*255 + 0.5,
    truncated — 0.255 -> 0, 0.51 -> 1, 254.97 -> 255."""
    img = np.array([[[0.001, 0.002, 0.9999]]], np.float32)
    p = str(tmp_path / "r.ppm")
    hio.save_image(p, img)
    raw = open(p, "rb").read()
    assert list(raw[-3:]) == [0, 1, 255]


def test_layout_converters(rng):
    img = rng.random((7, 9, 3)).astype(np.float32)
    planar = hio.hwc_to_planar(img)
    assert planar.shape == (3, 63)
    back = hio.planar_to_hwc(planar, 9)
    np.testing.assert_array_equal(back, img)

    inline = hio.hwc_to_interleaved_rgba(img)
    assert inline.shape == (7 * 9 * 4,)
    assert (inline.reshape(-1, 4)[:, 3] == 0).all()  # zero padding lane
    back = hio.interleaved_rgba_to_hwc(inline, 9)
    np.testing.assert_array_equal(back, img)
