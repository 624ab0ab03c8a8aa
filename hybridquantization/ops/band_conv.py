"""Separable convolution as block-banded matmuls.

The S-CIELAB 1-D convolutions (21 taps x 7 channels) are reformulated here
as matrix multiplication:

A symmetric-filter correlation y[i] = sum_t k[t] x[i+t-half] restricted to
128-wide blocks is block-Toeplitz: with x split into 128-pixel blocks X_j,

    Y_j = X_{j-1} @ A + X_j @ B + X_{j+1} @ C

where A/B/C are constant (128, 128) banded matrices built from the taps
(A: taps reaching back into the previous block, B: the main band, C: taps
reaching into the next block). The reference's half-sample symmetric
reflection (OptimizedConvolution.cl:21-27) enters as:
  - left edge: a small triangular correction matrix E_left added to block 0
    (the mirrored x[-m-1] = x[m] terms fold back into block 0 itself,
    valid because half < 128)
  - right edge: the input is mirror-extended into the zero-padding that
    rounds W up to a block multiple, so no special-casing is needed there.

Both passes use the same matrices: the horizontal pass right-multiplies row
blocks, the vertical pass left-multiplies with the transposes. f32
(HIGHEST) keeps reference parity.

Requires half-width <= 128 (band fits in adjacent blocks), i.e. up to 257
taps; the default S-CIELAB bank is 21 taps, undecimated high-dpi banks reach
~247.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

BLOCK = 128


def build_band_matrices(kernels: np.ndarray):
    """Per-channel (A, B, C, E_left) block-band matrices from (C, taps) taps.

    Layout convention: y_block = x_block @ M with M[row=x_pos, col=y_pos],
    i.e. M[j, i] = k[j - i + half] (coefficient of x_j in y_i).
    """
    kernels = np.asarray(kernels, np.float32)
    C, taps = kernels.shape
    half = taps // 2
    # The +/-1-block band covers any half-width up to BLOCK (x for outputs in
    # block j spans blocks j-1..j+1 when half <= BLOCK).
    if half > BLOCK:
        raise ValueError(
            f"filter half-width {half} exceeds the one-block band ({BLOCK})"
        )

    j = np.arange(BLOCK)[:, None]
    i = np.arange(BLOCK)[None, :]

    def band(offset):
        # x global pos = j + offset*BLOCK; coeff index = (j + off*B) - i + half
        t = j + offset * BLOCK - i + half
        valid = (t >= 0) & (t < taps)
        out = np.zeros((C, BLOCK, BLOCK), np.float32)
        tt = np.clip(t, 0, taps - 1)
        for c in range(C):
            out[c] = np.where(valid, kernels[c][tt], 0.0)
        return out

    A = band(-1)  # previous block
    B = band(0)   # main
    Cm = band(+1)  # next block

    # Left-edge reflection: y_i (i < half) receives k[-(m+1) - i + half]
    # from virtual x_{-(m+1)} == x_m  ->  E[m, i] = k[half - 1 - m - i].
    t = half - 1 - j - i
    valid = (t >= 0) & (t < taps)
    E = np.zeros((C, BLOCK, BLOCK), np.float32)
    tt = np.clip(t, 0, taps - 1)
    for c in range(C):
        E[c] = np.where(valid, kernels[c][tt], 0.0)

    return A, B, Cm, E


def _mirror_extend(x: jnp.ndarray, half: int, axis: int) -> jnp.ndarray:
    """Pad `axis` to a BLOCK multiple that fits the full `half` mirror tail.

    The band reads up to x[n-1+half]; those positions MUST hold the mirrored
    samples (zeros there would corrupt the last `half` outputs), so the
    padded length is ceil((n + half) / BLOCK) * BLOCK: mirror first, zeros
    after.
    """
    n = x.shape[axis]
    nb = -(-(n + half) // BLOCK)
    pad_total = nb * BLOCK - n
    mirror = lax.rev(lax.slice_in_dim(x, n - half, n, axis=axis), (axis,))
    zshape = list(x.shape)
    zshape[axis] = pad_total - half
    tail = jnp.concatenate([mirror, jnp.zeros(zshape, x.dtype)], axis=axis)
    return jnp.concatenate([x, tail], axis=axis)


_PREC = lax.Precision.HIGHEST


def _shifted(x_blocks: jnp.ndarray, shift: int, axis: int) -> jnp.ndarray:
    """Neighbor blocks along the block axis, zero block at the open edge."""
    nb = x_blocks.shape[axis]
    zshape = list(x_blocks.shape)
    zshape[axis] = 1
    zero = jnp.zeros(zshape, x_blocks.dtype)
    if shift == -1:  # X_{j-1}
        body = lax.slice_in_dim(x_blocks, 0, nb - 1, axis=axis)
        return jnp.concatenate([zero, body], axis=axis)
    body = lax.slice_in_dim(x_blocks, 1, nb, axis=axis)  # X_{j+1}
    return jnp.concatenate([body, zero], axis=axis)


def conv_h_banded(x: jnp.ndarray, mats, taps_half: int) -> jnp.ndarray:
    """(C, H, W) horizontal pass. mats from build_band_matrices (as jnp)."""
    A, B, Cm, E = mats
    C, H, W = x.shape
    xp = _mirror_extend(x, taps_half, axis=2)
    nb = xp.shape[2] // BLOCK
    xb = xp.reshape(C, H, nb, BLOCK)

    def mm(xs, M):  # (C,H,nb,128) x (C,128,128) -> contract last dim of xs
        return jnp.einsum("chjb,cbk->chjk", xs, M, precision=_PREC)

    y = mm(xb, B) + mm(_shifted(xb, -1, 2), A) + mm(_shifted(xb, +1, 2), Cm)
    # left-edge reflection correction on block 0
    y0 = y[:, :, 0, :] + jnp.einsum(
        "chb,cbk->chk", xb[:, :, 0, :], E, precision=_PREC
    )
    y = jnp.concatenate([y0[:, :, None, :], y[:, :, 1:, :]], axis=2)
    return y.reshape(C, H, nb * BLOCK)[:, :, :W]


def conv_v_banded(x: jnp.ndarray, mats, taps_half: int) -> jnp.ndarray:
    """(C, H, W) vertical pass via left-multiplication with transposes."""
    A, B, Cm, E = mats
    C, H, W = x.shape
    xp = _mirror_extend(x, taps_half, axis=1)
    nb = xp.shape[1] // BLOCK
    xb = xp.reshape(C, nb, BLOCK, W)

    def mm(M, xs):  # y[c,j,k,w] = sum_b M[c,b,k] xs[c,j,b,w]
        return jnp.einsum("cbk,cjbw->cjkw", M, xs, precision=_PREC)

    y = mm(B, xb) + mm(A, _shifted(xb, -1, 1)) + mm(Cm, _shifted(xb, +1, 1))
    y0 = y[:, 0] + jnp.einsum(
        "cbk,cbw->ckw", E, xb[:, 0], precision=_PREC
    )
    y = jnp.concatenate([y0[:, None], y[:, 1:]], axis=1)
    return y.reshape(C, nb * BLOCK, W)[:, :H, :]


def conv_v_banded_valid(x: jnp.ndarray, mats, taps_half: int) -> jnp.ndarray:
    """Vertical banded conv in VALID mode for halo-extended row strips.

    x: (C, Hs + 2*half, W) — a local strip with `half` real halo rows above
    and below (parallel.halo). Returns (C, Hs, W): only rows with full
    support; no reflection is applied (shard boundaries are interior).
    """
    A, B, Cm, E = mats
    del E  # no edge reflection in valid mode
    C, Hin, W = x.shape
    nb = -(-Hin // BLOCK)
    pad = nb * BLOCK - Hin
    if pad:
        x = jnp.concatenate(
            [x, jnp.zeros((C, pad, W), x.dtype)], axis=1
        )
    xb = x.reshape(C, nb, BLOCK, W)

    def mm(M, xs):
        return jnp.einsum("cbk,cjbw->cjkw", M, xs, precision=_PREC)

    y = mm(B, xb) + mm(A, _shifted(xb, -1, 1)) + mm(Cm, _shifted(xb, +1, 1))
    y = y.reshape(C, nb * BLOCK, W)
    return y[:, taps_half : Hin - taps_half, :]
