"""Nearest-palette assignment.

jnp/XLA implementation (the fused GPU kernel lives in `ops.triton_assign`).
The K-way nearest-neighbor search is expressed as one matmul via the
expansion

    ||p - c_k||^2 = ||p||^2 - 2 p.c_k + ||c_k||^2
    argmin_k ||p - c_k||^2 = argmax_k (2 p.c_k - ||c_k||^2)

so the (P, K) score matrix is `2 * pixels @ palette.T` minus a per-palette
bias — a (P, 3) x (3, K) matmul. Pixels are processed in blocks so the score
matrix never materializes in HBM for large images.

Reference parity: the reference assigns by Euclidean distance in *nonlinear
sRGB* space (quantize / quantizeAndConvertToOpp kernels,
OptimizedConvolution.cl:147-199) with first-minimum tie-breaking; the
perceptual model only enters through the fitness. The BASELINE north star
additionally asks for Delta-E (LAB-space) assignment; both are supported by
passing pixel/palette features in the desired space.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _dot(pixels, palette, precision):
    return jax.lax.dot_general(
        pixels,
        palette,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )


def _scores(
    pixels: jnp.ndarray, palette: jnp.ndarray, precision: str = "highest"
) -> jnp.ndarray:
    """(P, K) matmul scores whose argmax == nearest-palette argmin.

    precision (same modes as ops.triton_assign): "highest" keeps the
    distance comparison in true f32 — a float32 dot at default precision may
    run in TF32 or bf16 depending on the device, which can flip assignments
    between nearby palette colors (the reference computes f32 distances,
    OptimizedConvolution.cl:155). "f32x3" is the 3-pass hi/lo bf16 split
    (|err| ~1e-6); "bf16" rounds both operands to bf16 (f32 accumulation).
    """
    if precision == "highest":
        dots = _dot(pixels, palette, jax.lax.Precision.HIGHEST)
    elif precision == "bf16":
        # bf16 products are exact in f32; the bias comes from the rounded
        # palette too, as in ops.triton_assign.
        pixels = pixels.astype(jnp.bfloat16)
        palette = palette.astype(jnp.bfloat16)
        dots = _dot(pixels, palette, jax.lax.Precision.DEFAULT)
        palette = palette.astype(jnp.float32)
    elif precision == "f32x3":
        ph = pixels.astype(jnp.bfloat16)
        pl_ = (pixels - ph.astype(jnp.float32)).astype(jnp.bfloat16)
        ch = palette.astype(jnp.bfloat16)
        cl = (palette - ch.astype(jnp.float32)).astype(jnp.bfloat16)
        d = jax.lax.Precision.DEFAULT
        dots = _dot(ph, ch, d) + _dot(ph, cl, d) + _dot(pl_, ch, d)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return 2.0 * dots - jnp.sum(palette * palette, axis=-1)[None, :]


def nearest_palette(
    pixels: jnp.ndarray,
    palette: jnp.ndarray,
    *,
    block_size: int = 1 << 16,
    precision: str = "highest",
) -> jnp.ndarray:
    """Index of the nearest palette entry for every pixel.

    Args:
      pixels: (P, F) pixel features (F = 3).
      palette: (K, F) palette features in the same space.
      block_size: pixels per block; the (block, K) score tile stays on-chip.

    Returns:
      (P,) int32 indices. Ties resolve to the first (lowest) index, matching
      the reference's strict-less scan (OptimizedConvolution.cl:158-167).
    """
    P = pixels.shape[0]
    if P <= block_size:
        return jnp.argmax(
            _scores(pixels, palette, precision), axis=-1
        ).astype(jnp.int32)

    pad = (-P) % block_size
    padded = jnp.pad(pixels, ((0, pad), (0, 0)))
    blocks = padded.reshape(-1, block_size, pixels.shape[1])

    def one(block):
        return jnp.argmax(
            _scores(block, palette, precision), axis=-1
        ).astype(jnp.int32)

    idx = jax.lax.map(one, blocks).reshape(-1)
    return idx[:P]


def palette_usage(idx: jnp.ndarray, num_colors: int) -> jnp.ndarray:
    """(K,) bool — whether any pixel selected each palette entry.

    The equivalent of the reference's benign-race `usedColors[i] = 1`
    device writes (OptimizedConvolution.cl:169,193): a scatter-OR.
    """
    return (
        jnp.zeros((num_colors,), jnp.bool_).at[idx].set(True, mode="drop")
    )


@functools.partial(jax.jit, static_argnames=("block_size",))
def assign_with_usage(
    pixels: jnp.ndarray,
    palette: jnp.ndarray,
    *,
    block_size: int = 1 << 16,
):
    """(indices, usage) in one call."""
    idx = nearest_palette(pixels, palette, block_size=block_size)
    return idx, palette_usage(idx, palette.shape[0])


def lloyd_step(
    pixels: jnp.ndarray,
    palette: jnp.ndarray,
    *,
    block_size: int = 1 << 16,
    precision: str = "highest",
    x_planar: jnp.ndarray | None = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """One Lloyd (k-means) step: move each palette entry to the centroid of
    its assigned pixels; entries no pixel selected keep their color.

    The per-palette color partial sums are the "centroid partial sums" of
    the BASELINE north star; under pixel sharding they combine with one
    psum. The reference has no refinement stage at all — its anneal is the
    only optimizer — so this is a beyond-parity feature: Lloyd steps are
    monotone in assignment-space MSE.

    x_planar: the pixels packed for the fused GPU kernel
    (triton_assign.pack_pixels); when given, the assignment runs in that
    kernel instead of XLA. Only single-image entry points pass it: a Pallas
    call has no partitioning rule, so it must not sit under a sharded jit.
    """
    K = palette.shape[0]
    if x_planar is not None:
        from . import triton_assign

        idx = triton_assign.assign_population(
            x_planar, palette[None], palette[None], pixels.shape[0],
            precision=precision, interpret=interpret,
        )[0][0]
    else:
        idx = nearest_palette(
            pixels, palette, block_size=block_size, precision=precision
        )
    sums = jax.ops.segment_sum(pixels, idx, num_segments=K)
    counts = jax.ops.segment_sum(
        jnp.ones((pixels.shape[0],), pixels.dtype), idx, num_segments=K
    )
    safe = jnp.maximum(counts, 1.0)[:, None]
    return jnp.where(counts[:, None] > 0, sums / safe, palette)


@functools.partial(
    jax.jit,
    static_argnames=("iters", "block_size", "precision", "use_kernel", "interpret"),
)
def lloyd_polish(
    pixels: jnp.ndarray,
    palette: jnp.ndarray,
    iters: int = 10,
    *,
    block_size: int = 1 << 16,
    precision: str = "highest",
    use_kernel: bool = False,
    interpret: bool = False,
) -> jnp.ndarray:
    """`iters` Lloyd steps (see lloyd_step) as one compiled loop.

    use_kernel: assign with the fused GPU kernel (single-image entry points
    only, lloyd_step doc); the pixels are packed once outside the loop.
    """
    x_planar = None
    if use_kernel:
        from . import triton_assign

        x_planar = triton_assign.pack_pixels(pixels)

    def body(_, pal):
        return lloyd_step(
            pixels, pal, block_size=block_size, precision=precision,
            x_planar=x_planar, interpret=interpret,
        )

    return jax.lax.fori_loop(0, iters, body, palette)


def polish_palette(
    pixels_srgb: jnp.ndarray,
    palette_srgb: jnp.ndarray,
    space: str,
    whitepoint,
    iters: int,
    method: str = "auto",
    use_kernel: bool = False,
) -> jnp.ndarray:
    """Lloyd-polish an sRGB palette in the given assignment space.

    The single shared rule used by both the single-image engine and the
    sharded batch engine: "lab" converts to CIELAB, polishes there, and
    maps back with gamut clamping; "srgb" polishes directly. Always
    returns sRGB in [0, 1].

    method: "exact" runs per-pixel Lloyd steps; "hist" runs them on a
    2^18-bin weighted histogram (one pixel-sized scatter total instead of
    one per step; it keeps ~80% of the polish deltaE improvement); "auto"
    = hist for large images in BOTH spaces. The histogram always bins sRGB
    values (1/64-wide bins); for "lab" the count-weighted bin centers are
    converted to CIELAB and the Lloyd steps run there — the in-bin
    mean-vs-convert (Jensen) error is far below a bin width.
    use_kernel: "exact" assigns with the fused GPU kernel (lloyd_step doc).
    """
    from .. import colorspace as cs

    if method == "auto":
        method = "hist" if pixels_srgb.shape[0] >= (1 << 20) else "exact"
    if space == "lab":
        wp = jnp.asarray(whitepoint)
        if method == "hist":
            from .kmeans import color_histogram, lloyd_steps_weighted

            counts, centers = color_histogram(pixels_srgb, 6)
            out = lloyd_steps_weighted(
                counts,
                cs.srgb_to_lab(centers, wp),
                cs.srgb_to_lab(palette_srgb, wp),
                iters,
            )
        elif method == "exact":
            out = lloyd_polish(
                cs.srgb_to_lab(pixels_srgb, wp),
                cs.srgb_to_lab(palette_srgb, wp),
                iters,
                use_kernel=use_kernel,
            )
        else:
            raise ValueError(f"unknown polish method {method!r}")
        return jnp.clip(cs.lab_to_srgb(out, wp), 0.0, 1.0)
    if space != "srgb":
        raise ValueError(f"unknown assignment space {space!r}")
    if method == "hist":
        from .kmeans import lloyd_polish_hist

        out = lloyd_polish_hist(pixels_srgb, palette_srgb, iters)
    elif method == "exact":
        out = lloyd_polish(pixels_srgb, palette_srgb, iters, use_kernel=use_kernel)
    else:
        raise ValueError(f"unknown polish method {method!r}")
    return jnp.clip(out, 0.0, 1.0)


def quantize_image(image_hwc: jnp.ndarray, palette: jnp.ndarray) -> jnp.ndarray:
    """Replace each pixel by its nearest palette color (same feature space).

    Mirrors the final `quantize` device pass (ImageManipulation.java:770-798).
    """
    H, W, F = image_hwc.shape
    idx = nearest_palette(image_hwc.reshape(-1, F), palette)
    return palette[idx].reshape(H, W, F)


def bayer_matrix(order: int = 3) -> jnp.ndarray:
    """(2^order, 2^order) ordered-dither thresholds in [-0.5, 0.5).

    Recursive Bayer construction; mean-zero so dithering adds no DC bias.
    """
    m = np.zeros((1, 1), np.float32)
    for _ in range(order):
        m = np.block([
            [4 * m + 0, 4 * m + 2],
            [4 * m + 3, 4 * m + 1],
        ])
    size = m.shape[0]
    # (k + 0.5)/n^2 - 0.5 centers the threshold set exactly at zero mean.
    return jnp.asarray((m + 0.5) / (size * size) - 0.5, jnp.float32)


def dither_perturbation(
    image_hwc: jnp.ndarray,
    palette: jnp.ndarray,
    strength,
    order: int = 3,
) -> jnp.ndarray:
    """Image + tiled mean-zero Bayer thresholds scaled by palette spacing.

    The single source of the Bayer + palette-spacing perturbation math used
    by both quantize_image_dithered and pipeline.HybridQuantizer.quantize.
    strength may be a traced scalar (varying it never recompiles).
    """
    H, W, _ = image_hwc.shape
    K = palette.shape[0]
    bayer = bayer_matrix(order)
    n = bayer.shape[0]
    tiles = bayer[
        jnp.arange(H)[:, None] % n, jnp.arange(W)[None, :] % n
    ]  # (H, W)
    # palette spacing: mean distance from each entry to its nearest other
    d2 = jnp.sum(
        (palette[:, None, :] - palette[None, :, :]) ** 2, axis=-1
    ) + jnp.eye(K) * 1e9
    spacing = jnp.mean(jnp.sqrt(jnp.min(d2, axis=-1)))
    return image_hwc + (strength * spacing) * tiles[..., None]


def quantize_image_dithered(
    image_hwc: jnp.ndarray,
    palette: jnp.ndarray,
    strength: float = 1.0,
    order: int = 3,
) -> jnp.ndarray:
    """Ordered (Bayer) dithered nearest-palette quantization.

    Beyond-reference feature: the reference hard-assigns every pixel, which
    bands smooth gradients at small K. Ordered dithering perturbs each pixel
    by a tiled mean-zero threshold matrix scaled by the local palette
    spacing before the nearest lookup — spatially stable, fully parallel
    (unlike error-diffusion dithers, which are sequential scans and a poor
    fit for any wide-vector hardware). strength=1 spreads thresholds over
    the mean nearest-neighbor distance between palette entries.
    """
    H, W, F = image_hwc.shape
    perturbed = dither_perturbation(image_hwc, palette, strength, order)
    idx = nearest_palette(perturbed.reshape(-1, F), palette)
    return palette[idx].reshape(H, W, F)
