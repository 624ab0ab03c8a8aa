"""Nearest-palette assignment: MXU-matmul formulation vs direct distances."""

import numpy as np
import jax.numpy as jnp

from hybridquantization.ops import assign

from . import oracle


def _check_vs_oracle(pixels, palette):
    got = np.asarray(assign.nearest_palette(jnp.asarray(pixels), jnp.asarray(palette)))
    want = oracle.nearest_palette(pixels.astype(np.float64), palette.astype(np.float64))
    if not np.array_equal(got, want):
        # matmul-trick f32 rounding may flip near-exact ties; any disagreement
        # must be between entries at (numerically) equal distance.
        d = np.linalg.norm(
            pixels[:, None, :].astype(np.float64) - palette[None].astype(np.float64),
            axis=-1,
        )
        bad = got != want
        np.testing.assert_allclose(
            d[bad, got[bad]], d[bad, want[bad]], rtol=1e-4, atol=1e-5
        )


def test_small(rng):
    _check_vs_oracle(
        rng.random((500, 3), dtype=np.float32), rng.random((16, 3), dtype=np.float32)
    )


def test_blocked_path_matches_unblocked(rng):
    pixels = rng.random((10_000, 3), dtype=np.float32)
    palette = rng.random((64, 3), dtype=np.float32)
    a = np.asarray(assign.nearest_palette(pixels, palette, block_size=1 << 20))
    b = np.asarray(assign.nearest_palette(pixels, palette, block_size=1024))
    np.testing.assert_array_equal(a, b)
    _check_vs_oracle(pixels, palette)


def test_non_multiple_block(rng):
    pixels = rng.random((1000, 3), dtype=np.float32)
    palette = rng.random((8, 3), dtype=np.float32)
    a = np.asarray(assign.nearest_palette(pixels, palette, block_size=300))
    b = np.asarray(assign.nearest_palette(pixels, palette, block_size=1 << 20))
    np.testing.assert_array_equal(a, b)


def test_tie_breaks_to_first_index():
    """Duplicate palette entries: the reference's strict-less scan keeps the
    first index (OptimizedConvolution.cl:158-167)."""
    palette = np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.9, 0.9, 0.9]], np.float32)
    pixels = np.array([[0.51, 0.5, 0.5], [0.9, 0.9, 0.9]], np.float32)
    idx = np.asarray(assign.nearest_palette(pixels, palette))
    np.testing.assert_array_equal(idx, [0, 2])


def test_usage(rng):
    palette = rng.random((8, 3), dtype=np.float32)
    # pixels exactly at 3 palette entries
    pixels = palette[np.array([1, 5, 5, 7])]
    idx, used = assign.assign_with_usage(jnp.asarray(pixels), jnp.asarray(palette))
    np.testing.assert_array_equal(np.asarray(idx), [1, 5, 5, 7])
    np.testing.assert_array_equal(
        np.asarray(used), [False, True, False, False, False, True, False, True]
    )


def test_quantize_image(rng):
    img = rng.random((10, 12, 3), dtype=np.float32)
    palette = rng.random((4, 3), dtype=np.float32)
    out = np.asarray(assign.quantize_image(jnp.asarray(img), jnp.asarray(palette)))
    assert out.shape == img.shape
    # every output pixel is a palette color
    flat = out.reshape(-1, 3)
    dists = np.linalg.norm(flat[:, None] - palette[None], axis=-1).min(1)
    assert dists.max() < 1e-6
    # idempotent
    again = np.asarray(assign.quantize_image(jnp.asarray(out), jnp.asarray(palette)))
    np.testing.assert_array_equal(out, again)


def _assign_mse(pixels, palette):
    d = np.linalg.norm(pixels[:, None] - palette[None], axis=-1).min(1)
    return float(np.mean(d**2))


def test_lloyd_step_monotone_mse(rng):
    """Every Lloyd step is non-increasing in assignment-space MSE."""
    pixels = rng.random((4000, 3), dtype=np.float32)
    palette = rng.random((8, 3), dtype=np.float32)
    prev = _assign_mse(pixels, palette)
    pal = jnp.asarray(palette)
    for _ in range(6):
        pal = assign.lloyd_step(jnp.asarray(pixels), pal)
        cur = _assign_mse(pixels, np.asarray(pal))
        assert cur <= prev + 1e-7
        prev = cur


def test_lloyd_step_is_centroid(rng):
    """Each updated entry equals the mean of its assigned pixels; entries
    with no pixels keep their color."""
    pixels = rng.random((1000, 3), dtype=np.float32)
    palette = np.concatenate(
        [rng.random((4, 3), dtype=np.float32), [[5.0, 5.0, 5.0]]]
    ).astype(np.float32)  # entry 4 is far outside [0,1] -> never chosen
    idx = np.asarray(assign.nearest_palette(pixels, palette))
    new = np.asarray(assign.lloyd_step(jnp.asarray(pixels), jnp.asarray(palette)))
    for k in range(4):
        sel = pixels[idx == k]
        if len(sel):
            np.testing.assert_allclose(new[k], sel.mean(0), rtol=1e-5)
    np.testing.assert_array_equal(new[4], palette[4])


def test_lloyd_polish_matches_steps(rng):
    pixels = rng.random((500, 3), dtype=np.float32)
    palette = rng.random((5, 3), dtype=np.float32)
    pal = jnp.asarray(palette)
    for _ in range(3):
        pal = assign.lloyd_step(jnp.asarray(pixels), pal)
    fused = assign.lloyd_polish(jnp.asarray(pixels), jnp.asarray(palette), 3)
    np.testing.assert_allclose(np.asarray(fused), np.asarray(pal), atol=1e-6)


def test_engine_polish_improves_quality(rng):
    """HybridQuantizer.polish lowers assignment-space MSE from a rough
    palette, in both assignment spaces, and stays in gamut."""
    from hybridquantization import HybridQuantizer, QuantizationConfig, SWASAConfig

    img = rng.random((24, 32, 3), dtype=np.float32)
    pixels = img.reshape(-1, 3)
    palette = rng.random((6, 3), dtype=np.float32)
    for space in ["srgb", "lab"]:
        q = HybridQuantizer(
            QuantizationConfig(
                swasa=SWASAConfig(num_colors=6), assignment_space=space
            )
        )
        out = np.asarray(q.polish(img, palette, iters=8))
        assert out.shape == palette.shape
        assert out.min() >= 0.0 and out.max() <= 1.0
        if space == "srgb":
            assert _assign_mse(pixels, out) <= _assign_mse(pixels, palette)


def test_kmeans_init_palettes(rng):
    from hybridquantization.ops import kmeans

    pixels = np.concatenate(
        [
            rng.normal(c, 0.03, (500, 3)).clip(0, 1)
            for c in ([0.1, 0.2, 0.8], [0.9, 0.1, 0.1], [0.5, 0.9, 0.4])
        ]
    ).astype(np.float32)
    import jax

    key = jax.random.PRNGKey(0)
    pals = np.asarray(
        kmeans.kmeans_init_palettes(key, jnp.asarray(pixels), 3, 2)
    )
    assert pals.shape == (2, 3, 3)
    assert pals.min() >= 0.0 and pals.max() <= 1.0
    # each member's palette lands near the three generating cluster centers
    for pal in pals:
        for c in ([0.1, 0.2, 0.8], [0.9, 0.1, 0.1], [0.5, 0.9, 0.4]):
            assert np.linalg.norm(pal - np.asarray(c), axis=-1).min() < 0.08
    # deterministic
    again = np.asarray(
        kmeans.kmeans_init_palettes(key, jnp.asarray(pixels), 3, 2)
    )
    np.testing.assert_array_equal(pals, again)


def test_kmeans_init_beats_random_at_init(rng):
    """The k-means seeded population starts with a lower fitness than the
    reference's uniform-random init (the anneal itself is unchanged)."""
    from hybridquantization import HybridQuantizer, QuantizationConfig, SWASAConfig
    import dataclasses

    img = rng.random((32, 40, 3), dtype=np.float32)
    errs = {}
    for init in ["random", "kmeans"]:
        cfg = QuantizationConfig(
            swasa=SWASAConfig(num_colors=8, imax=1), init=init
        )
        q = HybridQuantizer(cfg)
        _, info = q.find_palette(img)
        errs[init] = info["best_error"]
    assert errs["kmeans"] < errs["random"]


def test_lloyd_polish_hist_close_to_exact(rng):
    """Histogram-space polish lands near the exact per-pixel polish."""
    from hybridquantization.ops.kmeans import lloyd_polish_hist

    pixels = rng.random((20000, 3), dtype=np.float32)
    palette = rng.random((8, 3), dtype=np.float32)
    exact = np.asarray(assign.lloyd_polish(jnp.asarray(pixels), jnp.asarray(palette), 5))
    hist = np.asarray(lloyd_polish_hist(jnp.asarray(pixels), jnp.asarray(palette), 5))
    # same MSE neighborhood (bins are 1/64 wide; centroids weighted means)
    assert _assign_mse(pixels, hist) <= _assign_mse(pixels, exact) * 1.05
    # and an improvement over the unpolished palette
    assert _assign_mse(pixels, hist) < _assign_mse(pixels, palette)


def test_polish_palette_lab_hist_close_to_exact(rng):
    """LAB-space histogram polish (round 5: bins sRGB, Lloyd-steps in
    CIELAB) lands near the exact per-pixel lab polish and improves
    lab-space MSE — the rule that previously forced lab polishing to the
    per-pixel path made the north-star mode pay the only per-pixel
    polish at 4K."""
    from hybridquantization import colorspace as cs

    wp = cs.WHITEPOINTS["D65"]
    pixels = rng.random((30000, 3), dtype=np.float32)
    palette = rng.random((8, 3), dtype=np.float32)

    def lab_mse(pal):
        px = np.asarray(cs.srgb_to_lab(jnp.asarray(pixels), jnp.asarray(wp)))
        pl = np.asarray(cs.srgb_to_lab(jnp.asarray(pal), jnp.asarray(wp)))
        d2 = ((px[:, None, :] - pl[None, :, :]) ** 2).sum(-1)
        return d2.min(1).mean()

    exact = np.asarray(
        assign.polish_palette(
            jnp.asarray(pixels), jnp.asarray(palette), "lab", wp, 5,
            method="exact",
        )
    )
    hist = np.asarray(
        assign.polish_palette(
            jnp.asarray(pixels), jnp.asarray(palette), "lab", wp, 5,
            method="hist",
        )
    )
    assert hist.min() >= 0.0 and hist.max() <= 1.0
    assert lab_mse(hist) <= lab_mse(exact) * 1.05
    assert lab_mse(hist) < lab_mse(palette)


def test_polish_palette_methods(rng):
    pixels = rng.random((5000, 3), dtype=np.float32)
    palette = rng.random((6, 3), dtype=np.float32)
    for method in ["exact", "hist", "auto"]:
        out = np.asarray(
            assign.polish_palette(
                jnp.asarray(pixels), jnp.asarray(palette), "srgb", None, 4,
                method=method,
            )
        )
        assert out.shape == palette.shape
        assert _assign_mse(pixels, out) < _assign_mse(pixels, palette)


def test_quantize_image_dithered(rng):
    """Dithered quantize: output stays on the palette, differs from the hard
    assignment on a smooth gradient, and dither=0 semantics match."""
    H, W = 32, 64
    grad = np.linspace(0.2, 0.8, W, dtype=np.float32)
    img = np.broadcast_to(grad[None, :, None], (H, W, 3)).copy()
    palette = np.stack([np.linspace(0.0, 1.0, 4, dtype=np.float32)] * 3, -1)
    hard = np.asarray(assign.quantize_image(jnp.asarray(img), jnp.asarray(palette)))
    dith = np.asarray(
        assign.quantize_image_dithered(
            jnp.asarray(img), jnp.asarray(palette), strength=1.0
        )
    )
    # every dithered pixel is a palette color
    d = np.linalg.norm(dith.reshape(-1, 3)[:, None] - palette[None], axis=-1)
    assert d.min(1).max() < 1e-6
    # dithering changes some assignments on the gradient
    assert (dith != hard).any()
    # the point of dithering: the spatial average tracks the ramp. Columns
    # are constant-valued, so the per-column mean must be closer to the true
    # ramp than the hard assignment's (which is just the quantized level).
    hard_err = np.abs(hard.mean(axis=0)[:, 0] - grad).mean()
    dith_err = np.abs(dith.mean(axis=0)[:, 0] - grad).mean()
    assert dith_err < hard_err


def test_bayer_matrix_properties():
    m = np.asarray(assign.bayer_matrix(3))
    assert m.shape == (8, 8)
    assert abs(m.mean()) < 1e-6
    assert len(np.unique(m)) == 64
