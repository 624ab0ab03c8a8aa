"""Fused nearest-palette assignment as a Pallas kernel on the Triton route.

One pass over the pixels does distance, first-index argmin, winner-colour
gather and usage flags: the GPU counterpart of the reference's
`quantizeAndConvertToOpp` OpenCL kernel (OptimizedConvolution.cl:172-199),
which loops over the palette for each work-item.

The XLA path (`ops.assign.nearest_palette`) writes a (pixels, K) f32 score
tile to device memory and reads it back for the argmax. Here the scores
never leave registers: pixels come in, an index and a colour go out.

Layout:

  x      (3, P_pad)      planar pixel features, P_pad a multiple of the
                         pixel block (`pack_pixels`)
  c      (pop, 4, K_pad) rows [c0, c1, c2, -|c|^2 / 2] per member; padded
                         entries carry bias -1e30 and never win
  o      (pop, 3, K_pad) the colour gathered for each winner (opponent
                         colours for the fitness, sRGB for the final pass)

Per grid step (pixel block i, member m) the kernel walks the palette in
order, as the reference does for each work-item: for entry k it computes

    s_k = f_p . c_k - |c_k|^2 / 2      (argmax_k s == argmin_k |f_p - c_k|)

as three f32 FMAs per pixel, with the palette values read as scalars, and
keeps the best score under a strict `>`, so exact ties resolve to the first
palette index like the reference's strict-less scan
(OptimizedConvolution.cl:158-167). A contraction of depth 3 gives the
tensor cores nothing to do, so the kernel uses the CUDA cores only.

Usage: each block ORs its hits per chunk of `block_k` palette entries and
issues one `atomic_max` per used entry into a zero-initialised (pop, K_pad)
int32 buffer that is aliased from input to output (GPU outputs are not
zero-filled). Blocks run in any order; nothing carries from one grid step
to the next.

Precision: "highest" and "f32x3" compute in f32 from f32 operands; "bf16"
rounds pixel and palette features to bf16 first (and takes the bias from
the rounded palette), then computes in f32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

PRECISIONS = ("highest", "f32x3", "bf16")

# Measured on an H100 at 4K/K=256/pop 4 against 2-D score-tile variants
# (PERF.md); the palette scan beat every tile shape tried.
BLOCK_P = 256     # pixels per grid step
BLOCK_K = 32      # palette entries per usage chunk
NUM_WARPS = 4

_NEG = -1e30  # bias of padded palette entries: never the maximum


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def block_k_for(num_colors: int) -> int:
    """Usage chunk: BLOCK_K, or the next power of two >= K if smaller."""
    return min(BLOCK_K, pl.next_power_of_2(max(num_colors, 1)))


def pack_pixels(features: jnp.ndarray) -> jnp.ndarray:
    """(P, 3) pixel features -> (3, P_pad) planar, zero-padded to a block."""
    P = features.shape[0]
    return jnp.pad(features, ((0, _round_up(P, BLOCK_P) - P), (0, 0))).T


def _bf16_round(a):
    return a.astype(jnp.bfloat16).astype(jnp.float32)


def pack_palettes(
    pal_feats: jnp.ndarray, colours: jnp.ndarray, precision: str = "highest"
):
    """(pop, K, 3) features + (pop, K, 3) colours -> (c (pop, 4, K_pad),
    o (pop, 3, K_pad)), K_pad a multiple of block_k_for(K)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    pop, K, _ = pal_feats.shape
    kp = _round_up(K, block_k_for(K))
    if precision == "bf16":
        pal_feats = _bf16_round(pal_feats)
    bias = -0.5 * jnp.sum(pal_feats * pal_feats, axis=-1)  # (pop, K)
    c = jnp.concatenate(
        [jnp.swapaxes(pal_feats, 1, 2), bias[:, None, :]], axis=1
    )
    c = jnp.pad(c, ((0, 0), (0, 0), (0, kp - K)))
    c = c.at[:, 3, K:].set(_NEG)
    o = jnp.pad(jnp.swapaxes(colours, 1, 2), ((0, 0), (0, 0), (0, kp - K)))
    return c.astype(jnp.float32), o.astype(jnp.float32)


def _assign_kernel(
    x_ref, c_ref, o_ref, u_in_ref, idx_ref, q_ref, u_ref, *,
    num_pixels: int, block_p: int, block_k: int, round_bf16: bool,
    masked_atomics: bool,
):
    del u_in_ref  # aliased with u_ref
    i = pl.program_id(0)  # pixel block
    m = pl.program_id(1)  # population member
    kp = c_ref.shape[2]
    px = pl.ds(i * block_p, block_p)
    x0 = plgpu.load(x_ref.at[0, px])
    x1 = plgpu.load(x_ref.at[1, px])
    x2 = plgpu.load(x_ref.at[2, px])
    if round_bf16:
        x0, x1, x2 = _bf16_round(x0), _bf16_round(x1), _bf16_round(x2)
    valid = i * block_p + jnp.arange(block_p) < num_pixels

    def scan(k, carry):
        best, idx = carry
        s = (
            x0 * plgpu.load(c_ref.at[m, 0, k])
            + x1 * plgpu.load(c_ref.at[m, 1, k])
            + x2 * plgpu.load(c_ref.at[m, 2, k])
            + plgpu.load(c_ref.at[m, 3, k])
        )
        better = s > best  # strict: the first of equal scores wins
        return jnp.where(better, s, best), jnp.where(better, k, idx)

    init = (
        jnp.full((block_p,), -jnp.inf, jnp.float32),
        jnp.zeros((block_p,), jnp.int32),
    )
    _, idx = lax.fori_loop(0, kp, scan, init)

    plgpu.store(idx_ref.at[m, px], idx)
    for ch in range(3):
        plgpu.store(q_ref.at[m, ch, px], plgpu.load(o_ref.at[m, ch, idx]))

    @pl.loop(0, kp // block_k)
    def _(kc):
        ids = kc * block_k + jnp.arange(block_k)
        hit = (idx[:, None] == ids[None, :]) & valid[:, None]
        used = jnp.max(hit.astype(jnp.int32), axis=0)
        # The mask only skips no-op atomics (max with 0 into a 0/1 buffer);
        # the Pallas interpreter has no masked atomics, so it issues them.
        plgpu.atomic_max(
            u_ref, (m, pl.ds(kc * block_k, block_k)), used,
            mask=used > 0 if masked_atomics else None,
        )


@functools.partial(
    jax.jit, static_argnames=("num_pixels", "precision", "interpret")
)
def assign_packed(
    x: jnp.ndarray,
    c: jnp.ndarray,
    o: jnp.ndarray,
    *,
    num_pixels: int,
    precision: str = "highest",
    interpret: bool = False,
):
    """Packed inputs -> (idx (pop, P_pad) int32, colours (pop, 3, P_pad),
    usage (pop, K_pad) int32 0/1). Pixels at or past `num_pixels` (the
    padding) never mark usage."""
    pp = x.shape[1]
    pop, _, kp = c.shape
    block_k = block_k_for(kp)
    if pp % BLOCK_P or kp % block_k:
        raise ValueError(
            f"padded sizes ({pp}, {kp}) must be multiples of the blocks "
            f"({BLOCK_P}, {block_k})"
        )
    kernel = functools.partial(
        _assign_kernel, num_pixels=num_pixels, block_p=BLOCK_P,
        block_k=block_k, round_bf16=precision == "bf16",
        masked_atomics=not interpret,
    )
    return pl.pallas_call(
        kernel,
        grid=(pp // BLOCK_P, pop),
        out_shape=[
            jax.ShapeDtypeStruct((pop, pp), jnp.int32),
            jax.ShapeDtypeStruct((pop, 3, pp), jnp.float32),
            jax.ShapeDtypeStruct((pop, kp), jnp.int32),
        ],
        input_output_aliases={3: 2},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        backend="triton",
        interpret=interpret,
        name="hq_assign",
    )(x, c, o, jnp.zeros((pop, kp), jnp.int32))


def assign_population(
    x: jnp.ndarray,
    pal_feats: jnp.ndarray,
    colours: jnp.ndarray,
    num_pixels: int,
    *,
    precision: str = "highest",
    interpret: bool = False,
):
    """Population assignment on pre-packed pixels.

    Args:
      x: (3, P_pad) from pack_pixels(features).
      pal_feats: (pop, K, 3) palettes in the feature space of x.
      colours: (pop, K, 3) colour gathered for each winner.
      num_pixels: true pixel count P.

    Returns:
      (idx (pop, P) int32, colours (pop, 3, P) f32, usage (pop, K) bool).
    """
    K = pal_feats.shape[1]
    c, o = pack_palettes(pal_feats, colours, precision)
    idx, q, used = assign_packed(
        x, c, o, num_pixels=num_pixels, precision=precision,
        interpret=interpret,
    )
    return idx[:, :num_pixels], q[:, :, :num_pixels], used[:, :K] > 0


def nearest_palette(
    features: jnp.ndarray,
    pal_feats: jnp.ndarray,
    *,
    precision: str = "highest",
    interpret: bool = False,
) -> jnp.ndarray:
    """(P,) int32: drop-in for ops.assign.nearest_palette on one palette."""
    P = features.shape[0]
    idx, _, _ = assign_population(
        pack_pixels(features), pal_feats[None], pal_feats[None], P,
        precision=precision, interpret=interpret,
    )
    return idx[0]
