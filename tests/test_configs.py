"""Config-surface coverage: every Delta-E formula, whitepoint, assignment
space, and Pallas toggle runs end-to-end and produces sane output."""

import numpy as np
import jax.numpy as jnp
import pytest

from hybridquantization import HybridQuantizer, QuantizationConfig, SWASAConfig
from hybridquantization.config import ScielabConfig
from hybridquantization.pipeline import _make_context, make_fitness


def _img(rng, h=24, w=28):
    return rng.random((h, w, 3), dtype=np.float32)


@pytest.mark.parametrize("delta_e", ["CIE76", "CIE94", "CIEDE2000"])
def test_delta_e_modes_run(rng, delta_e):
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=4, population=2, imax=15), deltaE=delta_e
    )
    q = HybridQuantizer(cfg)
    palette, info = q.find_palette(_img(rng))
    assert np.isfinite(info["best_error"])
    be = info["telemetry"]["best_error"]
    assert (np.diff(be) <= 1e-6).all()


def test_delta_e_formulas_differ(rng):
    """CIE94/2000 compress chroma differences: fitness values must differ
    from CIE76 on the same palette."""
    img = _img(rng)
    vals = {}
    for de in ["CIE76", "CIE94", "CIEDE2000"]:
        cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=4), deltaE=de)
        q = HybridQuantizer(cfg)
        ctx = _make_context(jnp.asarray(img), q.filters, cfg)
        palette = jnp.asarray(
            np.random.default_rng(0).random((4, 3)), jnp.float32
        )
        err, _ = make_fitness(ctx, cfg, q.filters.half_width)(palette)
        vals[de] = float(err)
    assert vals["CIE76"] != vals["CIE94"] != vals["CIEDE2000"]
    # CIE94/2000 are never larger than CIE76 for the same LAB pair
    assert vals["CIE94"] <= vals["CIE76"]


@pytest.mark.parametrize("wp", ["D65", "D50"])
def test_whitepoints(rng, wp):
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=4, population=1, imax=10),
        scielab=ScielabConfig(whitepoint=wp),
    )
    q = HybridQuantizer(cfg)
    _, info = q.find_palette(_img(rng))
    assert np.isfinite(info["best_error"])


def test_d50_differs_from_d65(rng):
    img = _img(rng)
    labs = {}
    for wp in ["D65", "D50"]:
        cfg = QuantizationConfig(scielab=ScielabConfig(whitepoint=wp))
        labs[wp] = np.asarray(HybridQuantizer(cfg).scielab(img))
    assert np.abs(labs["D65"] - labs["D50"]).max() > 0.1


def test_custom_scielab_params(rng):
    """Non-default dpi/viewing distance exercise the filter-bank paths
    (including uprate > 1 and uprate == 1)."""
    for dpi, dist in [(150, 60.0), (800, 45.0)]:
        cfg = QuantizationConfig(
            swasa=SWASAConfig(num_colors=4, population=1, imax=5),
            scielab=ScielabConfig(dpi=dpi, viewing_distance_cm=dist),
        )
        q = HybridQuantizer(cfg)
        h = max(q.filters.half_width * 2, 24)
        _, info = q.find_palette(_img(rng, h, h))
        assert np.isfinite(info["best_error"])


def test_use_pallas_off_equals_auto_on_cpu(rng):
    img = _img(rng)
    outs = []
    for mode in ["off", "auto"]:
        cfg = QuantizationConfig(
            swasa=SWASAConfig(num_colors=4, population=2, imax=20),
            use_pallas=mode,
            seed=11,
        )
        pal, info = HybridQuantizer(cfg).find_palette(img)
        outs.append((pal, info["best_error"]))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


def test_invalid_assignment_space(rng):
    cfg = QuantizationConfig(assignment_space="bogus")
    q = HybridQuantizer(cfg)
    with pytest.raises(ValueError, match="assignment_space"):
        q.find_palette(_img(rng))
