"""Separable convolution with half-sample symmetric (reflect) padding.

XLA formulation of the reference's two-pass transposed separable
convolution (OptimizedConvolution.cl:2-74, 234-306). The reference writes
each horizontal pass transposed so the next "horizontal" launch is
effectively vertical; under XLA we instead run a depthwise
`lax.conv_general_dilated` along each spatial axis on explicitly
symmetric-padded input — the compiler keeps both passes fused and coalesced,
no manual transposes needed.

Boundary handling matches the reference's index mirroring
(OptimizedConvolution.cl:21-27): off < 0 -> -off-1, off >= W -> 2W-off-1,
i.e. half-sample symmetric reflection (`jnp.pad(mode="symmetric")`).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def conv1d_symmetric(x: jnp.ndarray, kernels: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Per-channel 1-D convolution along a spatial axis with symmetric padding.

    Args:
      x: (C, H, W) image, one 1-D filter per channel.
      kernels: (C, taps) filters, taps odd.
      axis: 1 to convolve along H (vertical), 2 along W (horizontal).

    Returns:
      (C, H, W) filtered image, same dtype as x.

    Uses a depthwise conv (feature_group_count = C). XLA's conv is a
    cross-correlation (no kernel flip), which matches the reference's tap
    indexing (`filter[kOff] * input[j+i]` with both ascending,
    OptimizedConvolution.cl:18-28) exactly; the filters are even-symmetric
    anyway.
    """
    C, taps = kernels.shape
    half = taps // 2
    pad = [(0, 0), (0, 0), (0, 0)]
    pad[axis] = (half, half)
    xp = jnp.pad(x, pad, mode="symmetric")[None]  # (1, C, Hp, Wp)

    if axis == 2:
        rhs = kernels[:, None, None, :]  # (C, 1, 1, taps)
    else:
        rhs = kernels[:, None, :, None]  # (C, 1, taps, 1)

    out = lax.conv_general_dilated(
        xp,
        rhs.astype(x.dtype),
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=C,
        # True f32 taps: default precision may drop the conv to TF32 or
        # bf16, which breaks 1%-parity with the reference's f32 pipeline.
        precision=lax.Precision.HIGHEST,
    )
    return out[0]


def separable_conv2d_symmetric(x: jnp.ndarray, kernels: jnp.ndarray) -> jnp.ndarray:
    """Full separable (horizontal then vertical) per-channel convolution."""
    return conv1d_symmetric(conv1d_symmetric(x, kernels, axis=2), kernels, axis=1)
