"""Checkpoint save/load + engine resume semantics."""

import numpy as np
import pytest

from hybridquantization import HybridQuantizer, QuantizationConfig, SWASAConfig
from hybridquantization.checkpoint import load_state, save_state


def _img(rng):
    return rng.random((24, 28, 3), dtype=np.float32)


def test_save_load_round_trip(tmp_path, rng):
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=4, population=2, imax=20))
    q = HybridQuantizer(cfg)
    img = _img(rng)
    _, info = q.find_palette(img)
    path = str(tmp_path / "ck.npz")
    save_state(path, info["state"], {"note": 42})
    state, extra = load_state(path)
    assert int(extra["note"]) == 42
    np.testing.assert_array_equal(
        np.asarray(state.best_colors), np.asarray(info["state"].best_colors)
    )
    assert int(state.iteration) == 20


def test_resume_matches_uninterrupted(tmp_path, rng):
    """Run 30 iters straight == run 15, checkpoint, reload, run 15 more."""
    img = _img(rng)

    cfg30 = QuantizationConfig(
        swasa=SWASAConfig(num_colors=4, population=2, imax=30), seed=3
    )
    q30 = HybridQuantizer(cfg30)
    pal_straight, info_straight = q30.find_palette(img, chunk_size=15)

    q15 = HybridQuantizer(cfg30)
    path = str(tmp_path / "mid.npz")
    # first half: stop after 15 via the progress callback
    _, info_half = q15.find_palette(
        img, chunk_size=15, progress=lambda done, imax, t: done < 15
    )
    save_state(path, info_half["state"])
    state, _ = load_state(path)
    pal_resumed, info_resumed = q15.find_palette(
        img, chunk_size=15, initial_state=state
    )

    np.testing.assert_allclose(pal_resumed, pal_straight, atol=1e-6)
    assert info_resumed["best_error"] == pytest.approx(
        info_straight["best_error"], rel=1e-6
    )


def test_periodic_checkpoint_written(tmp_path, rng):
    img = _img(rng)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=4, population=1, imax=40))
    q = HybridQuantizer(cfg)
    path = str(tmp_path / "per.npz")
    q.find_palette(img, chunk_size=10, checkpoint_path=path, checkpoint_every=20)
    state, _ = load_state(path)
    assert int(state.iteration) >= 20
