"""Fused Triton assignment kernel vs the XLA reference (Pallas interpret mode).

The kernel is compiled by Triton only on a GPU; here every call runs it in
the Pallas interpreter, which executes the same kernel body on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hybridquantization import QuantizationConfig, SWASAConfig, HybridQuantizer
from hybridquantization import colorspace as cs
from hybridquantization.ops import assign as aj
from hybridquantization.ops import triton_assign as ta
from hybridquantization.pipeline import (
    _make_context,
    make_fitness,
    make_population_fitness,
)

from . import oracle


def _data(rng, P, K):
    feats = jnp.asarray(rng.random((P, 3), dtype=np.float32))
    pal = jnp.asarray(rng.random((K, 3), dtype=np.float32))
    return feats, pal


def _assign(feats, pals, colours, precision="highest"):
    return ta.assign_population(
        ta.pack_pixels(feats), pals, colours, feats.shape[0],
        precision=precision, interpret=True,
    )


@pytest.mark.parametrize("P,K", [(4096, 16), (5000, 17), (2048, 256), (1000, 3)])
def test_single_matches_jnp(rng, P, K):
    feats, pal = _data(rng, P, K)
    opp_pal = cs.srgb_to_opp(pal)
    idx_ref = np.asarray(aj.nearest_palette(feats, pal))

    idx, opp, usage = _assign(feats, pal[None], opp_pal[None])
    np.testing.assert_array_equal(np.asarray(idx[0]), idx_ref)
    np.testing.assert_array_equal(np.asarray(opp[0]), np.asarray(opp_pal)[idx_ref].T)
    want_usage = np.zeros(K, bool)
    want_usage[idx_ref] = True
    np.testing.assert_array_equal(np.asarray(usage[0]), want_usage)

    got = ta.nearest_palette(feats, pal, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), idx_ref)


def test_population_matches_jnp(rng):
    P, K, pop = 4096 + 511, 16, 3
    feats = jnp.asarray(rng.random((P, 3), dtype=np.float32))
    pals = jnp.asarray(rng.random((pop, K, 3), dtype=np.float32))
    opps = jax.vmap(cs.srgb_to_opp)(pals)
    idx, opp, usage = _assign(feats, pals, opps)
    for p in range(pop):
        ref = np.asarray(aj.nearest_palette(feats, pals[p]))
        np.testing.assert_array_equal(np.asarray(idx[p]), ref)
        np.testing.assert_array_equal(np.asarray(opp[p]), np.asarray(opps[p])[ref].T)
        want = np.zeros(K, bool)
        want[ref] = True
        np.testing.assert_array_equal(np.asarray(usage[p]), want)


def test_usage_exact(rng):
    """The raw usage buffer holds exactly 1 for every entry some pixel won
    and 0 elsewhere, padded palette entries included, on a skewed
    distribution where most pixels pick one entry."""
    P, K, pop = 3000, 17, 2
    feats = jnp.asarray(rng.random((P, 3), dtype=np.float32))
    pals = jnp.asarray(rng.random((pop, K, 3), dtype=np.float32))
    feats = feats.at[: P // 2].set(pals[0, 5] + 1e-3)
    c, o = ta.pack_palettes(pals, pals)
    _idx, _q, used = ta.assign_packed(
        ta.pack_pixels(feats), c, o, num_pixels=P, interpret=True
    )
    used = np.asarray(used)
    assert used.dtype == np.int32 and used.shape == (pop, c.shape[2])
    for p in range(pop):
        ref = np.asarray(aj.nearest_palette(feats, pals[p]))
        np.testing.assert_array_equal(
            used[p], (np.bincount(ref, minlength=c.shape[2]) > 0).astype(np.int32)
        )


def test_padding_does_not_mark_usage():
    """Padded pixels (P not a block multiple) must not set usage flags."""
    pal = jnp.asarray(
        [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.5, 0.5], [0.9, 0.1, 0.1]],
        jnp.float32,
    )
    # all pixels exactly at entry 1; entry 0 would catch zero-padded pixels
    feats = jnp.ones((1000, 3), jnp.float32)
    _, _, usage = _assign(feats, pal[None], pal[None])
    np.testing.assert_array_equal(np.asarray(usage[0]), [False, True, False, False])


@pytest.mark.parametrize("precision", ["highest", "f32x3", "bf16"])
def test_tie_breaks_first_index(precision):
    """Exact ties resolve to the first palette index in every precision
    mode (the reference's strict-less scan, OptimizedConvolution.cl:158-167);
    duplicates must not double-mark usage or double-sum the winner."""
    pal = jnp.asarray(
        [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.9, 0.9, 0.9]], jnp.float32
    )
    feats = jnp.asarray([[0.51, 0.5, 0.5], [0.9, 0.9, 0.9]], jnp.float32)
    idx, q, usage = _assign(feats, pal[None], pal[None], precision)
    np.testing.assert_array_equal(np.asarray(idx[0]), [0, 2])
    np.testing.assert_array_equal(np.asarray(usage[0]), [True, False, True])
    np.testing.assert_array_equal(np.asarray(q[0]).T, np.asarray(pal)[[0, 2]])


@pytest.mark.parametrize("precision", ["f32x3", "bf16"])
def test_reduced_precision_flip_rate(rng, precision):
    """Against true-f32 XLA scores, a mode may flip only near-tied pixels:
    every flip is between entries whose f32 distances differ by less than
    the mode's error bound (f32 rounding for f32x3, whose kernel computes
    in f32; bf16 feature rounding ~2e-2), never a gross misassignment."""
    P, K = 8192, 64
    feats, pal = _data(rng, P, K)
    idx_ref = np.asarray(aj.nearest_palette(feats, pal, precision="highest"))
    idx = np.asarray(_assign(feats, pal[None], pal[None], precision)[0][0])
    flips = np.nonzero(idx != idx_ref)[0]
    d = np.asarray(feats)[:, None, :] - np.asarray(pal)[None, :, :]
    dist2 = (d * d).sum(-1)
    bound = 4e-5 if precision == "f32x3" else 4e-2
    for p in flips:
        gap = abs(dist2[p, idx[p]] - dist2[p, idx_ref[p]])
        assert gap < bound, (p, idx[p], idx_ref[p], gap)
    if precision == "f32x3":
        assert len(flips) <= P // 1000


def test_bf16_matches_xla_bf16_mode(rng):
    """"bf16" means the same thing on both paths: features rounded to bf16,
    f32 arithmetic. Flips between the two may only be near-ties of the
    rounded features."""
    P, K = 4096, 32
    feats, pal = _data(rng, P, K)
    ref = np.asarray(aj.nearest_palette(feats, pal, precision="bf16"))
    idx = np.asarray(_assign(feats, pal[None], pal[None], "bf16")[0][0])
    fr = np.asarray(feats.astype(jnp.bfloat16).astype(jnp.float32))
    pr = np.asarray(pal.astype(jnp.bfloat16).astype(jnp.float32))
    d2 = ((fr[:, None, :] - pr[None]) ** 2).sum(-1)
    flips = np.nonzero(idx != ref)[0]
    assert len(flips) <= P // 500
    for p in flips:
        assert abs(d2[p, idx[p]] - d2[p, ref[p]]) < 1e-5


def test_large_k_population_matches_jnp(rng):
    """K=1024: the palette scan has no size limit in K."""
    P, K, pop = 3000, 1024, 2
    feats = jnp.asarray(rng.random((P, 3), dtype=np.float32))
    pals = jnp.asarray(rng.random((pop, K, 3), dtype=np.float32))
    opps = jax.vmap(cs.srgb_to_opp)(pals)
    idx, opp, usage = _assign(feats, pals, opps)
    for p in range(pop):
        ref = np.asarray(aj.nearest_palette(feats, pals[p]))
        np.testing.assert_array_equal(np.asarray(idx[p]), ref)
        np.testing.assert_array_equal(np.asarray(opp[p]), np.asarray(opps[p])[ref].T)
        want = np.zeros(K, bool)
        want[ref] = True
        np.testing.assert_array_equal(np.asarray(usage[p]), want)


def test_block_sizes_and_packing(rng):
    """Power-of-two usage chunks; padded palette entries never win."""
    assert ta.block_k_for(1) == 1
    assert ta.block_k_for(3) == 4
    assert ta.block_k_for(16) == 16
    assert ta.block_k_for(17) == ta.BLOCK_K
    assert ta.block_k_for(1 << 20) == ta.BLOCK_K
    x = ta.pack_pixels(jnp.ones((1000, 3)))
    assert x.shape == (3, 1024)
    pals = jnp.asarray(rng.random((2, 5, 3), dtype=np.float32))
    c, o = ta.pack_palettes(pals, pals)  # K=5 -> chunk 8
    assert c.shape == (2, 4, 8) and o.shape == (2, 3, 8)
    np.testing.assert_array_equal(np.asarray(c[:, 3, 5:]), np.float32(-1e30))
    np.testing.assert_allclose(
        np.asarray(c[:, 3, :5]), -0.5 * (np.asarray(pals) ** 2).sum(-1)
    )
    with pytest.raises(ValueError, match="multiples of the blocks"):
        ta.assign_packed(x[:, :1000], c, o, num_pixels=1000, interpret=True)
    with pytest.raises(ValueError, match="unknown precision"):
        ta.pack_palettes(pals, pals, precision="tf32")


@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_kernel_fitness_matches_xla(rng, space):
    """Population fitness through the kernel == the XLA fitness."""
    img = rng.random((60, 50, 3), dtype=np.float32)
    pals = jnp.asarray(rng.random((2, 6, 3), dtype=np.float32))
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=6, population=2),
        assignment_space=space,
        precision="highest",
    )
    q = HybridQuantizer(cfg)
    res = {}
    for kernel in ["triton", "xla"]:
        ctx = _make_context(jnp.asarray(img), q.filters, cfg, kernel)
        fn = make_population_fitness(ctx, cfg, q.filters.half_width, interpret=True)
        e, u = jax.jit(fn)(pals)
        res[kernel] = (np.asarray(e), np.asarray(u))
    np.testing.assert_allclose(res["triton"][0], res["xla"][0], rtol=1e-6)
    np.testing.assert_array_equal(res["triton"][1], res["xla"][1])


def test_pipeline_with_kernel_forced(rng):
    """The kernel-backed population fitness equals make_fitness member by
    member, and is marked as a population function for the SWASA loop."""
    img = rng.random((24, 32, 3), dtype=np.float32)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=5), precision="highest")
    q = HybridQuantizer(cfg)
    ctx = _make_context(jnp.asarray(img), q.filters, cfg, "triton")
    assert "x_planar" in ctx
    pop_fn = make_population_fitness(ctx, cfg, q.filters.half_width, interpret=True)
    assert getattr(pop_fn, "is_population", False)
    pals = jnp.asarray(rng.random((3, 5, 3), dtype=np.float32))
    errs, usage = jax.jit(pop_fn)(pals)
    single = make_fitness(ctx, cfg, q.filters.half_width)
    for p in range(3):
        e, u = single(pals[p])
        assert float(errs[p]) == pytest.approx(float(e), rel=1e-5)
        np.testing.assert_array_equal(np.asarray(usage[p]), np.asarray(u))


@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_lloyd_polish_kernel_matches_xla(rng, space):
    """The exact Lloyd polish assigns with the kernel on a GPU; the result
    must equal the XLA polish."""
    pixels = jnp.asarray(rng.random((3000, 3), dtype=np.float32))
    pal = jnp.asarray(rng.random((8, 3), dtype=np.float32))
    if space == "lab":
        pixels = cs.srgb_to_lab(pixels)
        pal = cs.srgb_to_lab(pal)
    want = aj.lloyd_polish(pixels, pal, 4)
    got = aj.lloyd_polish(pixels, pal, 4, use_kernel=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("de", ["CIE76", "CIE94", "CIEDE2000"])
def test_xla_fitness_delta_e_variants_match_oracle(rng, de):
    """Every Delta-E kind of the XLA fitness == the f64 oracle, whose
    CIE94/CIEDE2000 are written independently (tests/oracle.py)."""
    img = rng.random((40, 48, 3)).astype(np.float32)
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=6), deltaE=de, precision="highest"
    )
    q = HybridQuantizer(cfg)
    ctx = _make_context(jnp.asarray(img), q.filters, cfg, "xla")
    fitness = jax.jit(make_fitness(ctx, cfg, q.filters.half_width))
    ofilters, abs_k3, _ = oracle.build_filters(72, 45.0)
    target = oracle.srgb_to_scielab(img.astype(np.float64), ofilters, abs_k3)
    for seed in range(2):
        pal = np.random.default_rng(seed).random((6, 3)).astype(np.float32)
        got, _ = fitness(jnp.asarray(pal))
        want = oracle.fitness(
            img.astype(np.float64), target, pal.astype(np.float64),
            ofilters, abs_k3, delta_e=de,
        )
        assert float(got) == pytest.approx(want, rel=1e-3)
