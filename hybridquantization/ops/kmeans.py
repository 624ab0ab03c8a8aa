"""Histogram-weighted k-means palette initialization (beyond-reference).

The reference seeds every SWASA population member with uniform-random
colors (SWASA.java:40-52), so early iterations are spent crawling out of
hopeless regions of palette space. This module seeds the anneal with a
weighted k-means solution instead, following the weighted-clustering idea
of "Fast Color Quantization Using Weighted Sort-Means Clustering"
(arXiv:1011.0093, PAPERS.md) recast for a jitted accelerator program:

  - dynamic structures (unique-color lists) become a STATIC 2^(3*bits)-bin
    color histogram (no data-dependent shapes under jit);
  - each Lloyd step is one (B, K) matmul + weighted segment sums;
  - every population member runs k-means from its own count-weighted
    random start, so the population stays diverse for the anneal.

SWASA itself is unchanged — with `init="random"` (the default) behavior is
bit-for-bit the reference's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def color_histogram(pixels: jnp.ndarray, bits: int = 5):
    """(counts (B,), centers (B, 3)) color histogram, B = 2^(3*bits) bins.

    centers hold the weighted mean color of each bin's pixels (empty bins
    fall back to the geometric bin center with zero weight).
    """
    n = 1 << bits
    B = n**3
    q = jnp.clip((pixels * n).astype(jnp.int32), 0, n - 1)
    bin_id = (q[:, 0] * n + q[:, 1]) * n + q[:, 2]
    counts = jax.ops.segment_sum(
        jnp.ones((pixels.shape[0],), jnp.float32), bin_id, num_segments=B
    )
    sums = jax.ops.segment_sum(pixels, bin_id, num_segments=B)
    ids = jnp.arange(B)
    grid = (
        jnp.stack([ids // (n * n), (ids // n) % n, ids % n], axis=-1) + 0.5
    ) / n
    centers = jnp.where(
        counts[:, None] > 0,
        sums / jnp.maximum(counts, 1.0)[:, None],
        grid.astype(jnp.float32),
    )
    return counts, centers


def weighted_kmeans(
    key: jax.Array,
    counts: jnp.ndarray,
    centers: jnp.ndarray,
    num_colors: int,
    iters: int = 25,
) -> jnp.ndarray:
    """(K, 3) palette: Lloyd on histogram bins with counts as weights.

    Start: K bins sampled without replacement with probability proportional
    to their pixel counts. Each step assigns every bin to its nearest
    palette entry (one matmul) and moves entries to the count-weighted
    centroid of their bins; entries with no bins keep their color.

    Images with fewer occupied histogram bins than K necessarily seed the
    surplus entries at zero-weight grid centers (shapes are static under
    jit, so "how many bins are occupied" cannot change the sample size).
    Those entries attract no bins and stay put — which is the right
    behavior: a K-entry palette for an image with < K distinct colors has
    surplus entries under ANY init, and SWASA's unused-color penalty is
    the mechanism that handles them (SURVEY.md 2b).
    """
    B = counts.shape[0]
    probs = counts / jnp.maximum(jnp.sum(counts), 1.0)
    start = jax.random.choice(
        key, B, (num_colors,), replace=False, p=probs
    )
    return lloyd_steps_weighted(counts, centers, centers[start], iters)


def lloyd_steps_weighted(
    counts: jnp.ndarray,
    centers: jnp.ndarray,
    palette: jnp.ndarray,
    iters: int,
) -> jnp.ndarray:
    """`iters` Lloyd steps on (counts, centers) from a GIVEN palette.

    The weighted-histogram core of weighted_kmeans without the random
    start — used by the fast polish path (ops.assign.polish_palette):
    after one histogram build, every step is a (B, K) matmul + weighted
    segment sums over B bins instead of P pixels.
    """
    K = palette.shape[0]

    def step(_, pal):
        scores = 2.0 * jnp.matmul(
            centers, pal.T, precision=jax.lax.Precision.HIGHEST
        ) - jnp.sum(pal * pal, axis=-1)[None, :]
        a = jnp.argmax(scores, axis=-1)
        wsums = jax.ops.segment_sum(
            centers * counts[:, None], a, num_segments=K
        )
        wtot = jax.ops.segment_sum(counts, a, num_segments=K)
        return jnp.where(
            wtot[:, None] > 0, wsums / jnp.maximum(wtot, 1.0)[:, None], pal
        )

    return jax.lax.fori_loop(0, iters, step, palette)


@functools.partial(jax.jit, static_argnames=("iters", "bits"))
def lloyd_polish_hist(
    pixels: jnp.ndarray,
    palette: jnp.ndarray,
    iters: int = 10,
    bits: int = 6,
) -> jnp.ndarray:
    """Lloyd polish on a 2^(3*bits)-bin weighted histogram of the pixels.

    One pixel-sized scatter total (the histogram build) instead of one per
    Lloyd step; each step then costs O(B*K) on bin centers. bits=6 bins are
    1/64 wide with count-weighted in-bin mean centers. Measured at 4K/K256
    after a kmeans+100-iteration anneal (10 steps): exact polish deltaE
    3.0309 in 1.43 s, hist bits=6 3.0403 in 0.27 s, bits=7 3.0326 in
    1.0 s (the scatter over 2^21 bins eats the win) — bits=6 keeps ~80%
    of the polish improvement at ~5x less cost.
    """
    counts, centers = color_histogram(pixels, bits)
    return lloyd_steps_weighted(counts, centers, palette, iters)


@functools.partial(
    jax.jit, static_argnames=("num_colors", "population", "bits", "iters")
)
def kmeans_init_palettes(
    key: jax.Array,
    pixels: jnp.ndarray,
    num_colors: int,
    population: int,
    bits: int = 5,
    iters: int = 25,
) -> jnp.ndarray:
    """(pop, K, 3) sRGB palettes — one weighted-k-means run per member,
    each from its own random count-weighted start."""
    counts, centers = color_histogram(pixels, bits)
    keys = jax.random.split(key, population)
    return jax.vmap(
        lambda k: weighted_kmeans(k, counts, centers, num_colors, iters)
    )(keys)
