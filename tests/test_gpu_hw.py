"""GPU hardware tier: the Triton-compiled assignment kernel on a real card.

The interpreter runs the same kernel body on the CPU (test_triton_assign.py),
but only the card compiles it through Triton, with its own FMA contraction,
masked atomics and scheduling. Run on a GPU with

    HQ_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu_hw.py -q

Elsewhere every test here skips (conftest fixture).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hybridquantization import HybridQuantizer, QuantizationConfig, SWASAConfig
from hybridquantization import colorspace as cs
from hybridquantization.ops import assign as aj
from hybridquantization.ops import triton_assign as ta
from hybridquantization.pipeline import _make_context, make_population_fitness

pytestmark = pytest.mark.gpu


def test_engine_picks_kernel_on_gpu():
    assert HybridQuantizer(QuantizationConfig()).kernel == "triton"


def test_first_index_ties_on_hardware(rng):
    """Exact-score ties resolve to the FIRST palette index on the card
    (OptimizedConvolution.cl:158-167), and duplicates never mark usage."""
    feats = rng.random((1024, 3)).astype(np.float32)
    pal = rng.random((8, 3)).astype(np.float32)
    pal[5] = pal[2]
    pal[7] = pal[0]
    feats[:16] = pal[5]
    feats[16:32] = pal[7]
    idx, q, usage = ta.assign_population(
        ta.pack_pixels(jnp.asarray(feats)), jnp.asarray(pal)[None],
        jnp.asarray(pal)[None], 1024,
    )
    idx, q, usage = np.asarray(idx[0]), np.asarray(q[0]), np.asarray(usage[0])
    assert (idx[:16] == 2).all() and (idx[16:32] == 0).all()
    np.testing.assert_array_equal(q[:, :16], np.broadcast_to(pal[2][:, None], (3, 16)))
    assert usage[2] and usage[0]
    assert not usage[5] and not usage[7]


@pytest.mark.parametrize("precision", ["highest", "f32x3"])
def test_kernel_flips_only_near_ties(rng, precision):
    """Compiled kernel vs XLA at true f32: indices differ only where the two
    f32 scores are within rounding (FMA contraction), usage is equal."""
    P, K = 1 << 16, 256
    feats = jnp.asarray(rng.random((P, 3)).astype(np.float32))
    pal = jnp.asarray(rng.random((K, 3)).astype(np.float32))
    idx, _, usage = ta.assign_population(
        ta.pack_pixels(feats), pal[None], pal[None], P, precision=precision
    )
    ref = np.asarray(aj.nearest_palette(feats, pal, precision="highest"))
    idx = np.asarray(idx[0])
    flips = np.nonzero(idx != ref)[0]
    assert len(flips) <= P * 1e-3
    d = np.asarray(feats, np.float64)[flips, None, :] - np.asarray(pal, np.float64)[None]
    d2 = (d * d).sum(-1)
    rows = np.arange(len(flips))
    assert (np.abs(d2[rows, idx[flips]] - d2[rows, ref[flips]]) < 1e-5).all()
    want = np.zeros(K, bool)
    want[ref] = True
    np.testing.assert_array_equal(np.asarray(usage[0]), want)


@pytest.mark.parametrize("de", ["CIE76", "CIE94", "CIEDE2000"])
def test_kernel_fitness_matches_xla_path_on_hardware(rng, de):
    """Population fitness with the compiled kernel == the XLA fitness."""
    img = rng.random((300, 520, 3)).astype(np.float32)
    pals = jnp.asarray(rng.random((2, 16, 3)).astype(np.float32))
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=16, population=2), deltaE=de,
        precision="highest",
    )
    q = HybridQuantizer(cfg)
    res = {}
    for kernel in ("triton", "xla"):
        ctx = _make_context(jnp.asarray(img), q.filters, cfg, kernel)
        fit = jax.jit(make_population_fitness(ctx, cfg, q.filters.half_width))
        e, u = fit(pals)
        res[kernel] = (np.asarray(e), np.asarray(u))
    np.testing.assert_allclose(res["triton"][0], res["xla"][0], rtol=2e-5)
    np.testing.assert_array_equal(res["triton"][1], res["xla"][1])


def test_8k_single_eval_and_usage(rng):
    """One kernel fitness eval at 8K (7680x4320, K=256) is finite, and a
    constant image marks exactly one palette entry over > 2^24 pixels."""
    H, W, K = 4320, 7680, 256
    img = np.tile(rng.random((540, 960, 3)).astype(np.float32), (8, 8, 1))
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=1))
    q = HybridQuantizer(cfg)
    ctx = _make_context(jnp.asarray(img), q.filters, cfg, "triton")

    @jax.jit
    def fit(ctx_, ps):
        return make_population_fitness(ctx_, cfg, q.filters.half_width)(ps)

    e, _ = fit(ctx, jnp.asarray(rng.random((1, K, 3)).astype(np.float32)))
    assert np.isfinite(np.asarray(e)).all()

    P = H * W
    pal = jnp.asarray(rng.random((K, 3)).astype(np.float32))
    _, _, usage = ta.assign_population(
        ta.pack_pixels(jnp.full((P, 3), 0.25, jnp.float32)), pal[None],
        pal[None], P,
    )
    usage = np.asarray(usage[0])
    assert usage.sum() == 1 and P > (1 << 24)


def test_checkpoint_resume_on_hardware(rng, tmp_path):
    """Checkpoint mid-anneal and resume == the uninterrupted run with the
    compiled kernel."""
    from hybridquantization.checkpoint import load_state, save_state

    img = rng.random((96, 128, 3)).astype(np.float32)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=6, population=2, imax=40))
    q = HybridQuantizer(cfg)
    key = jax.random.PRNGKey(3)
    pal_full, info_full = q.find_palette(img, key=key, chunk_size=20)

    path = str(tmp_path / "ck.npz")
    q2 = HybridQuantizer(cfg)
    _, info_half = q2.find_palette(
        img, key=key, chunk_size=20, progress=lambda done, imax, t: done < 20
    )
    save_state(path, info_half["state"])
    st_loaded, _ = load_state(path)
    pal_res, info_res = q2.find_palette(
        img, key=key, chunk_size=20, initial_state=st_loaded
    )
    np.testing.assert_array_equal(np.asarray(pal_full), np.asarray(pal_res))
    assert info_full["best_error"] == info_res["best_error"]


def test_row_sharded_path_on_hardware(rng):
    """The row-sharded batch engine on however many cards exist."""
    from hybridquantization.parallel import ShardedBatchQuantizer, make_mesh

    n = len(jax.devices())
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=4, population=2, imax=4), progress_every=2
    )
    q = ShardedBatchQuantizer(cfg, make_mesh(1, n))
    img = rng.random((1, 64 * n, 300, 3)).astype(np.float32)
    pal, info = q.find_palettes(img, chunk_size=2)
    assert np.isfinite(info["best_errors"]).all()
    assert np.asarray(q.quantize(img, pal)).shape == img.shape


def test_large_k_on_hardware(rng):
    """K=1024 through the compiled kernel: a short anneal, finite error."""
    img = rng.random((256, 384, 3)).astype(np.float32)
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=1024, population=2, imax=4)
    )
    q = HybridQuantizer(cfg)
    pal, info = q.find_palette(img, key=jax.random.PRNGKey(0), chunk_size=4)
    assert pal.shape == (1024, 3)
    assert np.isfinite(info["best_error"])
    out = np.asarray(q.quantize(img, pal))
    assert len(np.unique(out.reshape(-1, 3), axis=0)) <= 1024
