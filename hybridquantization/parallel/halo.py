"""Halo exchange for row-sharded separable convolution.

The vertical conv pass of the S-CIELAB filter needs `half` rows of context
above and below each device's row strip. Interior strip boundaries exchange
real neighbor rows via `lax.ppermute`; the true top/bottom image
edges apply the reference's half-sample symmetric reflection
(OptimizedConvolution.cl:21-27) — reflection must happen ONLY at true image
edges, never at shard boundaries (SURVEY.md section 7 "hard parts").
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .mesh import PIXEL_AXIS


def exchange_row_halos(x: jnp.ndarray, half: int, axis_name: str = PIXEL_AXIS):
    """(top_halo, bottom_halo) of `half` rows for a (C, Hs, W) local strip.

    Interior shards receive neighbor rows; edge shards get their own strip
    reflected (row -m maps to row m-1; row Hs-1+m maps to row Hs-m).
    """
    n = lax.axis_size(axis_name)
    i = lax.axis_index(axis_name)

    reflect_top = x[:, :half, :][:, ::-1, :]
    reflect_bottom = x[:, -half:, :][:, ::-1, :]

    if n == 1:
        return reflect_top, reflect_bottom

    # Device j sends its bottom rows down to j+1 (they sit *above* j+1's strip)
    from_above = lax.ppermute(
        x[:, -half:, :], axis_name, [(j, j + 1) for j in range(n - 1)]
    )
    # Device j sends its top rows up to j-1 (they sit *below* j-1's strip)
    from_below = lax.ppermute(
        x[:, :half, :], axis_name, [(j, j - 1) for j in range(1, n)]
    )

    top = jnp.where(i == 0, reflect_top, from_above)
    bottom = jnp.where(i == n - 1, reflect_bottom, from_below)
    return top, bottom


def conv1d_vertical_sharded(
    x: jnp.ndarray, kernels: jnp.ndarray, axis_name: str = PIXEL_AXIS
) -> jnp.ndarray:
    """Per-channel vertical 1-D conv on a row-sharded (C, Hs, W) strip.

    Requires Hs >= taps//2 (strip at least one halo tall).
    """
    C, taps = kernels.shape
    half = taps // 2
    top, bottom = exchange_row_halos(x, half, axis_name)
    xp = jnp.concatenate([top, x, bottom], axis=1)[None]  # (1, C, Hs+2*half, W)
    out = lax.conv_general_dilated(
        xp,
        kernels[:, None, :, None].astype(x.dtype),  # (C, 1, taps, 1)
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=C,
        precision=lax.Precision.HIGHEST,  # f32 parity (see ops.conv)
    )
    return out[0]
