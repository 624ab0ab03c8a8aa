"""End-to-end engine tests: golden fitness parity vs the oracle, full runs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hybridquantization import HybridQuantizer, QuantizationConfig, SWASAConfig
from hybridquantization.pipeline import _make_context, make_fitness

from . import oracle


def _test_image(rng, h=32, w=40):
    """Smooth-ish random image (block gradient + noise)."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack(
        [x / w, y / h, 0.5 + 0.25 * np.sin(x / 5.0) * np.cos(y / 7.0)], axis=-1
    )
    return np.clip(base + rng.normal(scale=0.05, size=(h, w, 3)), 0, 1).astype(
        np.float32
    )


def test_fitness_matches_oracle(rng):
    """THE golden parity test: our fused on-device fitness == an independent
    NumPy implementation of the reference per-evaluation pipeline."""
    img = _test_image(rng)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=6, delta=2.0))
    q = HybridQuantizer(cfg)
    ctx = _make_context(jnp.asarray(img), q.filters, cfg)
    fitness = make_fitness(ctx, cfg, q.filters.half_width)

    ofilters, abs_k3, _ = oracle.build_filters(cfg.scielab.dpi, cfg.scielab.viewing_distance_cm)
    target = oracle.srgb_to_scielab(img.astype(np.float64), ofilters, abs_k3)

    for seed in range(3):
        palette = np.random.default_rng(seed).random((6, 3)).astype(np.float32)
        got, usage = jax.jit(fitness)(jnp.asarray(palette))
        want = oracle.fitness(
            img.astype(np.float64), target, palette.astype(np.float64),
            ofilters, abs_k3, delta=2.0,
        )
        assert float(got) == pytest.approx(want, rel=1e-3)


def test_fitness_zero_for_perfect_palette(rng):
    """If the palette contains exactly the image's colors, Delta-E == 0."""
    palette = np.array(
        [[0.2, 0.3, 0.4], [0.8, 0.1, 0.5], [0.5, 0.9, 0.2], [0.1, 0.1, 0.9]],
        np.float32,
    )
    idx = np.random.default_rng(0).integers(0, 4, size=(24, 28))
    img = palette[idx]
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=4, delta=2.0))
    q = HybridQuantizer(cfg)
    ctx = _make_context(jnp.asarray(img), q.filters, cfg)
    err, usage = jax.jit(make_fitness(ctx, cfg, q.filters.half_width))(jnp.asarray(palette))
    assert float(err) < 1e-3
    assert bool(jnp.all(usage))


def test_unused_color_penalty_applied(rng):
    img = np.full((20, 20, 3), 0.5, np.float32)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=3, delta=2.0))
    q = HybridQuantizer(cfg)
    ctx = _make_context(jnp.asarray(img), q.filters, cfg)
    # one palette entry matches; the two far entries are never used -> 2*delta
    palette = jnp.asarray([[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    err, usage = jax.jit(make_fitness(ctx, cfg, q.filters.half_width))(palette)
    assert np.asarray(usage).tolist() == [True, False, False]
    assert float(err) == pytest.approx(4.0, abs=1e-2)


def test_full_run_improves_over_random(rng):
    img = _test_image(rng)
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=8, population=2, imax=60), seed=7
    )
    q = HybridQuantizer(cfg)
    palette, info = q.find_palette(img)
    assert palette.shape == (8, 3)
    assert info["iterations"] == 60
    be = info["telemetry"]["best_error"]
    assert be[-1] <= be[0]
    out = q.quantize(img, palette)
    uniq = np.unique(np.asarray(out).reshape(-1, 3), axis=0)
    assert len(uniq) <= 8


def test_progress_callback_and_stop(rng):
    img = _test_image(rng, 16, 16)
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=4, population=1, imax=100), progress_every=10
    )
    q = HybridQuantizer(cfg)
    calls = []

    def progress(done, imax, telemetry):
        calls.append(done)
        return done < 30  # stop after 30 iterations

    _, info = q.find_palette(img, progress=progress)
    assert calls == [10, 20, 30]
    assert info["iterations"] == 30


def test_error_image_matches_oracle(rng):
    img = _test_image(rng)
    quant = np.round(img * 4) / 4  # a crude quantization
    cfg = QuantizationConfig()
    q = HybridQuantizer(cfg)
    mean_de, viz = q.error_image(img, quant.astype(np.float32))

    ofilters, abs_k3, _ = oracle.build_filters(72, 45.0)
    lab1 = oracle.srgb_to_scielab(img.astype(np.float64), ofilters, abs_k3)
    lab2 = oracle.srgb_to_scielab(quant.astype(np.float64), ofilters, abs_k3)
    e = oracle.delta_e76(lab1, lab2)
    assert float(mean_de) == pytest.approx(e.mean(), rel=1e-3)
    # visualization mapping ((255-e)^2)/255^2 (ImageManipulation.java:890)
    want_viz = ((255 - e) ** 2) / 255**2
    np.testing.assert_allclose(np.asarray(viz)[..., 0], want_viz, rtol=1e-3)
    assert viz.shape == img.shape


def test_lab_assignment_mode(rng):
    img = _test_image(rng, 24, 24)
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=4, population=2, imax=30),
        assignment_space="lab",
    )
    q = HybridQuantizer(cfg)
    palette, info = q.find_palette(img)
    out = q.quantize(img, palette)
    assert np.isfinite(info["best_error"])
    uniq = np.unique(np.asarray(out).reshape(-1, 3), axis=0)
    assert len(uniq) <= 4


def test_run_full_flow(rng):
    img = _test_image(rng, 16, 20)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=4, population=1, imax=20))
    out, info = HybridQuantizer(cfg).run(img)
    assert out.shape == img.shape
    assert "palette" in info
