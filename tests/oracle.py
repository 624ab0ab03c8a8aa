"""Independent NumPy oracle of the reference pipeline.

Deliberately written in a different style from the package (scalar formulas,
scipy convolutions) so transcription errors in either side surface as test
failures. Semantics follow the reference's *active* (OpenCL) path:
  - color math: ScielabProcessor.java:271-366 with the corrected opponent
    matrices (OptimizedConvolution.cl:110,118,171 — see SURVEY.md 2e.1)
  - filter bank: ScielabProcessor.java:66-181
  - spatial filtering: computeScielabKernelsTemp/End
    (OptimizedConvolution.cl:234-306) with half-sample symmetric reflection
  - assignment: Euclidean nearest in sRGB, first-minimum ties
    (OptimizedConvolution.cl:147-199)
  - fitness: mean CIE76 Delta-E + unused-color penalty
    (ImageManipulation.java:701-714, SWASA.java:74-82)
"""

from __future__ import annotations

import math

import numpy as np
from scipy.ndimage import correlate1d

D65 = np.array([0.95047, 1.0, 1.0883])
D50 = np.array([0.966797, 1.0, 0.825188])

M_SRGB2XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ]
)
M_XYZ2OPP = np.array(
    [
        [0.2787336, 0.7218031, -0.1065520],
        [-0.4487736, 0.2898056, -0.0771569],
        [0.0859513, -0.5899859, 0.5011089],
    ]
)
M_OPP2XYZ = np.array(
    [
        [0.624045, -1.87044, -0.155304],
        [1.36606, 0.931563, 0.433903],
        [1.5013, 1.41761, 2.53307],
    ]
)


def _wdtype(x):
    """Working dtype: float32 stays float32 (the reference's active OpenCL
    path computes in `float`, OptimizedConvolution.cl); everything else is
    promoted to float64 (the definitional judge precision)."""
    x = np.asarray(x)
    return np.float32 if x.dtype == np.float32 else np.float64


def srgb_to_linear(c):
    c = np.asarray(c, _wdtype(c))
    return np.where(c <= 0.04045, c / 12.92, ((np.maximum(c, 0) + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = np.asarray(c, _wdtype(c))
    return np.where(
        c <= 0.0031308, 12.92 * c, 1.055 * np.maximum(c, 1e-12) ** (1 / 2.4) - 0.055
    )


def srgb_to_xyz(srgb):
    lin = srgb_to_linear(srgb)
    return lin @ M_SRGB2XYZ.T.astype(lin.dtype)


def xyz_to_opp(xyz):
    xyz = np.asarray(xyz, _wdtype(xyz))
    return xyz @ M_XYZ2OPP.T.astype(xyz.dtype)


def opp_to_xyz(opp):
    opp = np.asarray(opp, _wdtype(opp))
    return opp @ M_OPP2XYZ.T.astype(opp.dtype)


def xyz_to_lab(xyz, wp=D65):
    xyz = np.asarray(xyz, _wdtype(xyz))
    t = xyz / wp.astype(xyz.dtype)
    d3 = (6 / 29) ** 3
    kappa = 24389 / 27
    f = np.where(t > d3, np.cbrt(t), (kappa * t + 16) / 116)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return np.stack([116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)], axis=-1)


def opp_to_lab(opp, wp=D65):
    opp = np.asarray(opp, _wdtype(opp))
    if opp.dtype == np.float32:
        # Fused fast path: fold the whitepoint normalization into the
        # Opp->XYZ matrix (one GEMM straight to t = XYZ/wp, no divide pass).
        m = (M_OPP2XYZ / wp[:, None]).T.astype(np.float32)
        t = opp @ m
        d3 = np.float32((6 / 29) ** 3)
        f = np.where(
            t > d3,
            np.cbrt(t),
            t * np.float32(24389 / 27 / 116) + np.float32(16 / 116),
        )
        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        return np.stack([116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)], axis=-1)
    return xyz_to_lab(opp_to_xyz(opp), wp)


def delta_e76(lab1, lab2):
    d = np.asarray(lab1) - np.asarray(lab2)
    if d.dtype == np.float32:  # einsum avoids the abs/temporary passes
        return np.sqrt(np.einsum("...c,...c->...", d, d))
    return np.linalg.norm(d, axis=-1)


def delta_e94(lab1, lab2):
    """CIE94, graphic-arts constants (kL = 1, K1 = 0.045, K2 = 0.015), with
    the reference's asymmetry: the weights use the chroma of lab1
    (OptimizedConvolution.cl:218-226)."""
    lab1 = np.asarray(lab1, np.float64)
    lab2 = np.asarray(lab2, np.float64)
    dL = lab1[..., 0] - lab2[..., 0]
    c1 = np.hypot(lab1[..., 1], lab1[..., 2])
    c2 = np.hypot(lab2[..., 1], lab2[..., 2])
    dC = c1 - c2
    dE2 = np.sum((lab1 - lab2) ** 2, axis=-1)
    dH2 = np.maximum(dE2 - dL * dL - dC * dC, 0.0)
    return np.sqrt(
        dL**2 + (dC / (1 + 0.045 * c1)) ** 2 + dH2 / (1 + 0.015 * c1) ** 2
    )


def delta_e2000(lab1, lab2):
    """CIEDE2000 (kL = kC = kH = 1), in degrees, following Sharma, Wu &
    Dalal, "The CIEDE2000 color-difference formula" (2005), eqs. 2-23."""
    lab1 = np.asarray(lab1, np.float64)
    lab2 = np.asarray(lab2, np.float64)
    L1, a1, b1 = np.moveaxis(lab1, -1, 0)
    L2, a2, b2 = np.moveaxis(lab2, -1, 0)
    cbar7 = ((np.hypot(a1, b1) + np.hypot(a2, b2)) / 2) ** 7
    G = 0.5 * (1 - np.sqrt(cbar7 / (cbar7 + 25.0**7)))
    a1p, a2p = (1 + G) * a1, (1 + G) * a2
    C1p, C2p = np.hypot(a1p, b1), np.hypot(a2p, b2)
    h1p = np.degrees(np.arctan2(b1, a1p)) % 360
    h2p = np.degrees(np.arctan2(b2, a2p)) % 360
    h1p = np.where((a1p == 0) & (b1 == 0), 0.0, h1p)
    h2p = np.where((a2p == 0) & (b2 == 0), 0.0, h2p)
    zero = C1p * C2p == 0
    dh = h2p - h1p
    dh = np.where(dh > 180, dh - 360, np.where(dh < -180, dh + 360, dh))
    dh = np.where(zero, 0.0, dh)
    dHp = 2 * np.sqrt(C1p * C2p) * np.sin(np.radians(dh) / 2)
    hs = h1p + h2p
    hbar = np.where(
        np.abs(h1p - h2p) <= 180, hs / 2,
        np.where(hs < 360, (hs + 360) / 2, (hs - 360) / 2),
    )
    hbar = np.where(zero, hs, hbar)
    T = (
        1
        - 0.17 * np.cos(np.radians(hbar - 30))
        + 0.24 * np.cos(np.radians(2 * hbar))
        + 0.32 * np.cos(np.radians(3 * hbar + 6))
        - 0.20 * np.cos(np.radians(4 * hbar - 63))
    )
    Lbar = (L1 + L2) / 2
    Cbar7 = ((C1p + C2p) / 2) ** 7
    SL = 1 + 0.015 * (Lbar - 50) ** 2 / np.sqrt(20 + (Lbar - 50) ** 2)
    SC = 1 + 0.045 * (C1p + C2p) / 2
    SH = 1 + 0.015 * (C1p + C2p) / 2 * T
    RT = (
        -2 * np.sqrt(Cbar7 / (Cbar7 + 25.0**7))
        * np.sin(np.radians(60 * np.exp(-(((hbar - 275) / 25) ** 2))))
    )
    tL, tC, tH = (L2 - L1) / SL, (C2p - C1p) / SC, dHp / SH
    return np.sqrt(tL**2 + tC**2 + tH**2 + RT * tC * tH)


DELTA_E = {"CIE76": delta_e76, "CIE94": delta_e94, "CIEDE2000": delta_e2000}


# -- filter bank ------------------------------------------------------------

WEIGHTS = [[1.00327, 0.114416, -0.117686], [0.616725, 0.383275], [0.567885, 0.432115]]
HALFWIDTHS = [[0.05, 0.225, 7.0], [0.0685, 0.826], [0.0920, 0.6451]]


def gauss(halfwidth, width):
    alpha = 2 * math.sqrt(math.log(2)) / (halfwidth - 1)
    x = np.arange(width) - width // 2
    g = np.exp(-(alpha**2) * x**2)
    return g / g.sum()


def build_filters(dpi=72, dist_cm=45.0):
    """Returns (ofilters [3][ncomp arrays], abs_k3, samp_per_deg)."""
    spd = round(dpi / ((180 / math.pi) * math.atan(2.54 / dist_cm)))
    uprate = math.ceil(224 / spd) if spd < 224 else 1
    spd *= uprate

    width = math.ceil(spd / 2) * 2 - 1
    ofilters = []
    for ch in range(3):
        comps = []
        for w, hw in zip(WEIGHTS[ch], HALFWIDTHS[ch]):
            comps.append(gauss(hw * spd, width) * math.sqrt(abs(w)) * np.sign(w))
        ofilters.append(comps)

    if uprate > 1:
        upcol = np.array([(uprate - abs(uprate - i - 1)) / uprate for i in range(2 * uprate - 1)])
        # resize1D zero-pad to len+width-1 (centered)
        target = len(upcol) + width - 1
        pad = (target - len(upcol)) // 2
        upcol_r = np.zeros(target)
        upcol_r[pad : pad + len(upcol)] = upcol
        # conv1D: same-size correlation centered at len(filter)//2, zero bounds
        def conv_same(data, filt):
            full = np.convolve(data, filt[::-1], mode="full")
            off = len(filt) // 2
            # result[i] = sum_j filt[j+off] data[i+j] = corr; full conv index:
            # corr(data, filt)[i] = full_conv(data, reversed filt)[i + len(filt)-1 - off]
            start = len(filt) - 1 - off
            return full[start : start + len(data)]

        ups = [[conv_same(f, upcol_r) for f in comps] for comps in ofilters]
        s = len(ups[0][0])
        mid = s // 2
        n = mid // uprate
        downs = mid + uprate * np.arange(-n, n + 1)
        ofilters = [[u[downs] for u in comps] for comps in ups]

    abs_k3 = np.abs(ofilters[0][2])
    return ofilters, abs_k3, spd


# -- spatial filtering ------------------------------------------------------

def scielab_filter_direct(opp_hwc, ofilters, abs_k3):
    """Per-channel sum of separable filters, symmetric reflection padding.

    Horizontal+vertical pass per component; the luminance channel's third
    component uses |k3| vertically. Direct spatial form (scipy correlate1d)
    — the definitional implementation; scielab_filter below is the fast
    FFT-equivalent used for large images.
    """
    out = np.zeros_like(opp_hwc)
    for c in range(3):
        acc = np.zeros(opp_hwc.shape[:2])
        for j, k in enumerate(ofilters[c]):
            kv = abs_k3 if (c == 0 and j == 2) else k
            t = correlate1d(opp_hwc[..., c], k, axis=1, mode="reflect")
            acc += correlate1d(t, kv, axis=0, mode="reflect")
        out[..., c] = acc
    return out


def _fft_len(n: int) -> int:
    """Smallest 5-smooth length >= n (pocketfft is fast at these)."""
    m = n
    while True:
        k = m
        for f in (2, 3, 5):
            while k % f == 0:
                k //= f
        if k == 1:
            return m
        m += 1


_TRANSFER_CACHE: dict = {}


def _channel_transfer(ofilters, abs_k3, Hf, Wf, dtype=np.float64):
    """(3, Hf, Wf//2+1) combined per-channel transfer functions.

    Each channel's filter is a sum of separable outer products kv_j x kh_j
    (the luminance channel's third component uses |k3| vertically); all
    components fold into ONE circular-convolution transfer function per
    channel. The component Gaussians are symmetric, so correlation equals
    convolution. Always built in f64, then cast to the working complex
    dtype (complex64 for the float32 search mode).
    """
    key = (Hf, Wf, np.dtype(dtype).str, abs_k3.tobytes(),
           tuple(k.tobytes() for comps in ofilters for k in comps))
    hit = _TRANSFER_CACHE.get(key)
    if hit is not None:
        return hit
    width = len(abs_k3)
    half = width // 2
    tf = np.empty((3, Hf, Wf // 2 + 1), np.complex128)
    for c in range(3):
        ker = np.zeros((Hf, Wf))
        for j, kh in enumerate(ofilters[c]):
            kv = abs_k3 if (c == 0 and j == 2) else kh
            block = np.outer(kv, kh)  # rows = vertical taps
            # place centered at the origin with circular wrap
            rows = (np.arange(width) - half) % Hf
            cols = (np.arange(width) - half) % Wf
            ker[np.ix_(rows, cols)] += block
        tf[c] = np.fft.rfft2(ker)
    if np.dtype(dtype) == np.float32:
        tf = tf.astype(np.complex64)
    _TRANSFER_CACHE[key] = tf
    return tf


def scielab_filter(opp_hwc, ofilters, abs_k3):
    """FFT-equivalent of scielab_filter_direct (same reflection semantics).

    The image is half-sample-symmetric padded by the filter half-width
    (exactly the reflection context the direct form reads), then zero-padded
    to an FFT-friendly size: every retained output's support lies inside
    the symmetric pad, so the circular wrap never reaches it — the result
    equals the direct form to FFT rounding (~1e-12). One forward + one
    inverse transform per channel replaces 14 spatial passes.
    """
    from scipy import fft as sfft  # preserves float32 (np.fft upcasts)

    opp_hwc = np.asarray(opp_hwc, _wdtype(opp_hwc))
    H, W, _ = opp_hwc.shape
    half = len(abs_k3) // 2
    Hf, Wf = _fft_len(H + 2 * half), _fft_len(W + 2 * half)
    tf = _channel_transfer(ofilters, abs_k3, Hf, Wf, opp_hwc.dtype)
    xpad = np.pad(opp_hwc, ((half, half), (half, half), (0, 0)), mode="symmetric")
    # One batched transform over the 3 channels (channel-first layout);
    # the result is materialized contiguous — downstream pointwise chains
    # on a moveaxis view are ~10x slower.
    spec = sfft.rfft2(np.ascontiguousarray(np.moveaxis(xpad, -1, 0)), s=(Hf, Wf))
    y = sfft.irfft2(spec * tf, s=(Hf, Wf))
    return np.ascontiguousarray(
        np.moveaxis(y[:, half : half + H, half : half + W], 0, -1)
    )


def srgb_to_scielab(image_hwc, ofilters, abs_k3, wp=D65):
    opp = xyz_to_opp(srgb_to_xyz(image_hwc))
    return opp_to_lab(scielab_filter(opp, ofilters, abs_k3), wp)


# -- assignment + fitness ---------------------------------------------------

def nearest_palette(pixels, palette, chunk=1 << 17):
    """First-minimum nearest assignment (OptimizedConvolution.cl:147-170).

    argmin_k ||p - c_k||^2 == argmax_k (p.c_k - |c_k|^2/2); np.argmax keeps
    the first index on ties like the reference's strict-less scan. Chunked
    so the (P, K) score matrix never exceeds ~64 MB. Runs in float32 when
    both inputs are float32 (the search mode), float64 otherwise.
    """
    dt = np.float32 if (
        np.asarray(pixels).dtype == np.float32
        and np.asarray(palette).dtype == np.float32
    ) else np.float64
    pixels = np.asarray(pixels, dt)
    palette = np.asarray(palette, dt)
    aug = _augmented_palette(palette)
    out = np.empty(len(pixels), np.int64)
    pix_aug = np.empty((min(chunk, len(pixels)), 4), dt)
    pix_aug[:, 3] = 1.0
    for i in range(0, len(pixels), chunk):
        n = min(chunk, len(pixels) - i)
        pix_aug[:n, :3] = pixels[i : i + n]
        s = pix_aug[:n] @ aug.T
        out[i : i + n] = np.argmax(s, axis=1)
    return out


def _augmented_palette(flat):
    """(K, 4) palette with the -|c|^2/2 bias folded in as a 4th column, so
    one GEMM against [pixels | 1] yields biased scores with no extra
    subtraction pass. Shared by nearest_palette and fitness_population so
    both compute bit-identical scores."""
    aug = np.empty((len(flat), 4), flat.dtype)
    aug[:, :3] = flat
    aug[:, 3] = -0.5 * np.einsum("kc,kc->k", flat, flat)
    return aug


def fitness(
    image_hwc, target_lab, palette, ofilters, abs_k3, delta=2.0, wp=D65,
    delta_e="CIE76",
):
    H, W, _ = image_hwc.shape
    idx = nearest_palette(image_hwc.reshape(-1, 3), palette)
    used = np.zeros(len(palette), bool)
    used[idx] = True
    # The quantized image has only K distinct colors: run the pointwise
    # sRGB -> XYZ -> Opp chain on the PALETTE and gather (identical math,
    # K evaluations instead of H*W).
    opp_palette = xyz_to_opp(srgb_to_xyz(palette))
    q_opp = opp_palette[idx].reshape(H, W, 3)
    q_lab = opp_to_lab(scielab_filter(q_opp, ofilters, abs_k3), wp)
    de = DELTA_E[delta_e](target_lab, q_lab)
    return de.mean() + delta * (~used).sum()


def fitness_population(
    image_hwc, target_lab, palettes, ofilters, abs_k3, delta=2.0, wp=D65
):
    """All population members' fitness in one batched pass.

    Bit-identical math to `[fitness(..., p, ...) for p in palettes]` (same
    chunked matmul-argmax per member, same per-channel transfer functions;
    the FFT batches over pop*3 channels, and pocketfft evaluates batch
    members independently) — just fewer Python/FFT-plan round-trips, which
    is what the config-2-scale oracle run is bound by.
    """
    from scipy import fft as sfft

    palettes = np.asarray(palettes)
    pop, K, _ = palettes.shape
    image_hwc = np.asarray(image_hwc)
    H, W, _ = image_hwc.shape
    dt = np.float32 if (
        image_hwc.dtype == np.float32 and palettes.dtype == np.float32
    ) else np.float64

    # One (P, pop*K) score pass, argmax within each member's K-block
    # (identical per-member first-index semantics: the reshape keeps each
    # member's K scores contiguous and np.argmax scans them in order).
    pixels = image_hwc.reshape(-1, 3).astype(dt)
    flat = palettes.reshape(pop * K, 3).astype(dt)
    aug = _augmented_palette(flat)
    idx = np.empty((len(pixels), pop), np.int64)
    chunk = max((1 << 23) // max(pop * K, 1), 1024)
    pix_aug = np.empty((chunk, 4), dt)
    pix_aug[:, 3] = 1.0
    for i in range(0, len(pixels), chunk):
        n = min(chunk, len(pixels) - i)
        pix_aug[:n, :3] = pixels[i : i + n]
        s = pix_aug[:n] @ aug.T
        idx[i : i + n] = np.argmax(s.reshape(n, pop, K), axis=2)
    used = np.zeros((pop, K), bool)
    for m in range(pop):
        used[m, idx[:, m]] = True

    opp_pal = xyz_to_opp(srgb_to_xyz(palettes.astype(dt)))  # (pop, K, 3)
    # (pop, H, W, 3) gathered quantized opponent images.
    q_opp = opp_pal[np.arange(pop)[:, None], idx.T].reshape(pop, H, W, 3)

    half = len(abs_k3) // 2
    Hf, Wf = _fft_len(H + 2 * half), _fft_len(W + 2 * half)
    tf = _channel_transfer(ofilters, abs_k3, Hf, Wf, dt)
    xpad = np.pad(
        np.moveaxis(q_opp, -1, 1), ((0, 0), (0, 0), (half, half), (half, half)),
        mode="symmetric",
    )  # (pop, 3, H+2h, W+2h)
    spec = sfft.rfft2(xpad, s=(Hf, Wf))
    y = sfft.irfft2(spec * tf[None], s=(Hf, Wf))
    filt = np.ascontiguousarray(
        np.moveaxis(y[:, :, half : half + H, half : half + W], 1, -1)
    )
    q_lab = opp_to_lab(filt, wp)  # (pop, H, W, 3)
    de = delta_e76(target_lab[None], q_lab).reshape(pop, -1).mean(axis=1)
    return de + delta * (~used).sum(axis=1)


# -- the full SWASA loop (reference semantics, NumPy RNG) -------------------

def swasa_search(
    image_hwc,
    num_colors,
    seed=0,
    population=4,
    imax=5000,
    delta=2.0,
    convergence=True,
    conv_delay=0.75,
    conv_spread=0.15,
    t0=20.0,
    i_tc=20,
    alpha=0.9,
    s0=100.0,
    beta=5.3,
    dpi=72,
    dist_cm=45.0,
    dtype=np.float64,
    progress=None,
):
    """Faithful mirror of findBestQuantization (ImageManipulation.java:383-591)
    + SWASA.java, with an explicit NumPy RNG instead of icy.util.Random.

    dtype: working precision of the search. float64 is the definitional
    judge precision; float32 matches the reference's active OpenCL path
    (every device buffer in OptimizedConvolution.cl is `float`) and is ~2x
    faster — used for the config-2-scale parity run. RNG draws are always
    float64 (matching Java's double-valued Random) and the proposal clip
    happens in float64 before casting, so the two modes consume identical
    draws only until their first differing acceptance decision: the
    Metropolis test draws from the RNG only when d > 0, so once fitness
    rounding flips one accept/reject the RNG streams (and trajectories)
    diverge. The layer-3 parity comparison is distributional over seeds
    and does not rely on trajectory alignment (docs/PARITY.md).
    """
    rng = np.random.default_rng(seed)
    image_hwc = np.asarray(image_hwc, dtype)
    ofilters, abs_k3, _ = build_filters(dpi, dist_cm)
    target = srgb_to_scielab(image_hwc, ofilters, abs_k3)

    def fit_pop(pals):
        return fitness_population(
            image_hwc, target, pals, ofilters, abs_k3, delta=delta
        )

    colors = rng.random((population, num_colors, 3)).astype(dtype)
    current = np.asarray(fit_pop(colors), np.float64)
    best_i = current.argmin()
    best_err, best_colors = current[best_i], colors[best_i].copy()
    temperature = t0

    for ite in range(1, imax + 1):
        if progress is not None and ite % 100 == 0:
            progress(ite)
        if ite % i_tc == 0:
            temperature *= alpha
        step = 2 * s0 / (1 + np.exp(beta * ite / imax)) / 256.0
        proposals = np.clip(
            colors.astype(np.float64) + rng.uniform(-1, 1, colors.shape) * step,
            0, 1,
        ).astype(dtype)
        errors = np.asarray(fit_pop(proposals), np.float64)

        min_idx = errors.argmin()
        for i in range(population):
            d = errors[i] - current[i]
            if d <= 0 or np.exp(-d / temperature) > rng.random():
                current[i] = errors[i]
                colors[i] = proposals[i]
                if errors[i] < best_err:
                    best_err = errors[i]
                    best_colors = proposals[i].copy()
        if convergence and population > 1:
            keep_p = -np.tanh((ite - conv_delay * imax) / (conv_spread * imax)) / 2 + 0.5
            for i in range(population):
                if not (keep_p > rng.random()):
                    current[i] = errors[min_idx]
                    colors[i] = proposals[min_idx].copy()

    return best_colors, best_err
