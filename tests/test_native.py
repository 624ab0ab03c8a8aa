"""Native C++ loader vs PIL / pure-Python reference."""

import os
import subprocess

import numpy as np
import pytest

from hybridquantization import io as hio
from hybridquantization import native

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")


@pytest.fixture(scope="module", autouse=True)
def build_native():
    subprocess.run(["make", "-C", NATIVE_DIR, "-s"], check=True)
    assert native.available()


def _png(tmp_path, arr, name="t.png", mode=None):
    from PIL import Image

    img = Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode)
    p = str(tmp_path / name)
    img.save(p)
    return p


def test_png_rgb_roundtrip(tmp_path, rng):
    arr = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
    p = _png(tmp_path, arr)
    got = native.load_image(p)
    want = hio.load_image(p)  # PIL
    assert got.shape == (37, 53, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_png_gray_and_rgba(tmp_path, rng):
    gray = (rng.random((20, 30)) * 255).astype(np.uint8)
    p = _png(tmp_path, gray, "g.png")
    got = native.load_image(p)
    np.testing.assert_allclose(got[..., 0], gray / 255.0, atol=1e-6)
    np.testing.assert_array_equal(got[..., 0], got[..., 1])

    rgba = (rng.random((20, 30, 4)) * 255).astype(np.uint8)
    p = _png(tmp_path, rgba, "a.png")
    got = native.load_image(p)
    np.testing.assert_allclose(got, rgba[..., :3] / 255.0, atol=1e-6)


def test_png_palette(tmp_path, rng):
    from PIL import Image

    arr = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    img = Image.fromarray(arr).quantize(colors=8)
    p = str(tmp_path / "pal.png")
    img.save(p)
    got = native.load_image(p)
    want = np.asarray(img.convert("RGB"), np.float32) / 255.0
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_ppm(tmp_path, rng):
    arr = rng.random((24, 31, 3)).astype(np.float32)
    p = str(tmp_path / "t.ppm")
    hio.save_image(p, arr)
    got = native.load_image(p)
    want = hio.load_image(p)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_batch_parallel(tmp_path, rng):
    paths = []
    arrays = []
    for i in range(9):
        arr = (rng.random((40, 32, 3)) * 255).astype(np.uint8)
        arrays.append(arr)
        paths.append(_png(tmp_path, arr, f"b{i}.png"))
    batch = native.load_batch(paths, num_threads=4)
    assert batch.shape == (9, 40, 32, 3)
    for i in range(9):
        np.testing.assert_allclose(batch[i], arrays[i] / 255.0, atol=1e-6)


def test_batch_failure_raises(tmp_path, rng):
    arr = (rng.random((10, 10, 3)) * 255).astype(np.uint8)
    good = _png(tmp_path, arr)
    bad = str(tmp_path / "missing.png")
    with pytest.raises(IOError):
        native.load_batch([good, bad])


def test_layout_converters(rng):
    img = rng.random((13, 17, 3)).astype(np.float32)
    planar = native.hwc_to_planar(img)
    np.testing.assert_array_equal(planar, hio.hwc_to_planar(img))
    back = native.planar_to_hwc(planar, 17)
    np.testing.assert_array_equal(back, img)


def test_float_to_u8_round_half_up():
    x = np.array([0.0, 0.00196, 0.5, 0.998, 1.0, 1.5, -0.2], np.float32)
    got = native.float_to_u8(x)
    want = np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
