"""CLI surface tests (in-process main(), CPU backend via conftest).

The CLI is the reference GUI's parameter panel (HybridQuantization.java:
185-257); these cover the three subcommands end-to-end on tiny inputs.
"""

import numpy as np
import pytest
from PIL import Image

from hybridquantization.cli import main


@pytest.fixture()
def png(tmp_path, rng):
    x = rng.random((32, 40, 3)).astype(np.float32)
    p = tmp_path / "in.png"
    Image.fromarray((x * 255).astype(np.uint8)).save(p)
    return p


def _unique_colors(path):
    arr = np.asarray(Image.open(path))
    return len(np.unique(arr.reshape(-1, arr.shape[-1]), axis=0))


def test_quantize_cli(png, tmp_path):
    out = tmp_path / "out.png"
    pal = tmp_path / "pal.npy"
    err = tmp_path / "err.png"
    rc = main([
        "quantize", str(png), str(out), "--colors", "5", "--imax", "20",
        "--population", "2", "--palette-out", str(pal),
        "--error-image", str(err),
    ])
    assert rc == 0
    assert _unique_colors(out) <= 5
    assert np.load(pal).shape == (5, 3)
    assert np.asarray(Image.open(err)).shape[:2] == (32, 40)


def test_quantize_cli_kmeans_polish(png, tmp_path):
    out = tmp_path / "out.png"
    rc = main([
        "quantize", str(png), str(out), "--colors", "5", "--imax", "10",
        "--population", "2", "--init", "kmeans", "--polish", "3",
    ])
    assert rc == 0
    assert _unique_colors(out) <= 5


def test_error_cli_mismatched_sizes(png, tmp_path, rng, capsys):
    other = tmp_path / "other.png"
    Image.fromarray(
        (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    ).save(other)
    rc = main(["error", str(png), str(other), "--out", str(tmp_path / "e.png")])
    assert rc == 2  # "Mismatching image sizes, abort." (reference parity)


def test_quantize_cli_checkpoint_resume(png, tmp_path, capsys):
    out = tmp_path / "out.png"
    ckpt = tmp_path / "state.npz"
    rc = main([
        "quantize", str(png), str(out), "--colors", "4", "--imax", "10",
        "--population", "2", "--checkpoint", str(ckpt),
    ])
    assert rc == 0 and ckpt.exists()
    capsys.readouterr()
    rc = main([
        "quantize", str(png), str(out), "--colors", "4", "--imax", "16",
        "--population", "2", "--checkpoint", str(ckpt),
    ])
    assert rc == 0
    assert "resuming from" in capsys.readouterr().out
