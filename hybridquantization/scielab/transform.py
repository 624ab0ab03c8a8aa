"""S-CIELAB forward transform: opponent-space spatial filtering -> CIELAB.

The equivalent of the reference's device pipeline
(ImageManipulation.XYZtoScielab, ImageManipulation.java:285-370, and the
fused hot-loop kernels computeScielabKernelsTemp/End,
OptimizedConvolution.cl:234-306):

  XYZ -> Opp -> [per-channel sum of separable Gaussian components] -> LAB

Channel c of the filtered image is
    conv2(opp_c, k1_c) + conv2(opp_c, k2_c)            (c = 0, 1, 2)
  + conv_h(conv_h(opp_0, k3), |k3|)                    (c = 0 only)
where conv2 is the separable outer-product filter and the luminance
channel's third (negative-weight) component applies |k3| on the vertical
pass so its sign lands exactly once (ScielabProcessor.java:174-178,
ImageManipulation.java:343).

All seven 1-D component convolutions per pass run as ONE depthwise XLA conv
over a stacked 7-channel image — the analog of the reference packing all
channels into float4 lanes to convolve them simultaneously.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import colorspace as cs
from ..ops.conv import conv1d_symmetric
from ..ops.band_conv import build_band_matrices, conv_h_banded, conv_v_banded
from .filters import ScielabFilters, build_filters  # noqa: F401 (re-export)


def stacked_kernels(filters: ScielabFilters, vertical: bool) -> jnp.ndarray:
    """(7, taps) kernel stack: [k1_0, k1_1, k1_2, k2_0, k2_1, k2_2, k3]."""
    k3 = filters.k3_abs if vertical else filters.k3
    return jnp.concatenate(
        [jnp.asarray(filters.k1).T, jnp.asarray(filters.k2).T, jnp.asarray(k3)[None]],
        axis=0,
    )


def scielab_filter_stacked(
    opp_chw: jnp.ndarray, kh: jnp.ndarray, kv: jnp.ndarray
) -> jnp.ndarray:
    """Filter with prebuilt (7, taps) kernel stacks (depthwise-conv path)."""
    x7 = jnp.concatenate([opp_chw, opp_chw, opp_chw[:1]], axis=0)  # (7, H, W)
    t = conv1d_symmetric(x7, kh, axis=2)   # horizontal pass
    y = conv1d_symmetric(t, kv, axis=1)    # vertical pass
    out = y[:3] + y[3:6]
    return out.at[0].add(y[6])


def band_matrices(filters: ScielabFilters):
    """(mats_h, mats_v) block-band matrix sets for the banded conv path.

    mats_* are 4-tuples of (7, 128, 128) arrays (A, B, C, E_left) from
    ops.band_conv; horizontal and vertical differ only in the 7th channel
    (k3 vs |k3|, ScielabProcessor.java:174-178).
    """
    import numpy as np

    kh = np.concatenate(
        [filters.k1.T, filters.k2.T, filters.k3[None]], axis=0
    )
    kv = np.concatenate(
        [filters.k1.T, filters.k2.T, filters.k3_abs[None]], axis=0
    )
    mh = build_band_matrices(kh)
    mv = build_band_matrices(kv)
    return tuple(jnp.asarray(m) for m in mh), tuple(jnp.asarray(m) for m in mv)


def scielab_filter_banded(
    opp_chw: jnp.ndarray, mats_h, mats_v, half: int
) -> jnp.ndarray:
    """S-CIELAB filtering via block-banded matmuls (ops.band_conv).

    Exact to f32 rounding vs scielab_filter_stacked.
    """
    x7 = jnp.concatenate([opp_chw, opp_chw, opp_chw[:1]], axis=0)  # (7, H, W)
    t = conv_h_banded(x7, mats_h, half)
    y = conv_v_banded(t, mats_v, half)
    out = y[:3] + y[3:6]
    return out.at[0].add(y[6])


def scielab_filter_opp(opp_chw: jnp.ndarray, filters: ScielabFilters) -> jnp.ndarray:
    """Apply the S-CIELAB spatial filter bank to an opponent image.

    Args:
      opp_chw: (3, H, W) opponent-space image.
      filters: packed filter bank.

    Returns:
      (3, H, W) filtered opponent image.
    """
    kh = stacked_kernels(filters, vertical=False)
    kv = stacked_kernels(filters, vertical=True)
    return scielab_filter_stacked(opp_chw, kh, kv)


def opp_to_scielab(opp_chw: jnp.ndarray, filters: ScielabFilters, whitepoint) -> jnp.ndarray:
    """Filtered opponent (3, H, W) -> S-CIELAB (H, W, 3)."""
    filtered = scielab_filter_opp(opp_chw, filters)
    return cs.opp_to_lab(jnp.moveaxis(filtered, 0, -1), whitepoint)


def srgb_to_scielab(
    image_hwc: jnp.ndarray,
    filters: ScielabFilters,
    whitepoint=cs.WHITEPOINT_D65,
) -> jnp.ndarray:
    """sRGB (H, W, 3) -> S-CIELAB (H, W, 3).

    Mirrors ScielabProcessor.sRGBToScielab (ScielabProcessor.java:374-381):
    sRGB -> XYZ -> Opp -> spatial filter -> LAB.
    """
    opp = cs.xyz_to_opp(cs.srgb_to_xyz(image_hwc))
    return opp_to_scielab(jnp.moveaxis(opp, -1, 0), filters, whitepoint)
