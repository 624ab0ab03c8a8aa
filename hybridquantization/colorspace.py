"""Color-space math: sRGB <-> XYZ <-> Opponent <-> CIELAB, and Delta-E metrics.

Pure, jit-friendly jax.numpy functions over arrays with a trailing channel
dimension of 3. All constants are float32, matching the reference plugin's
fp32 pipeline.

Reference parity notes
----------------------
Matrices reproduce the *active* (OpenCL) path of the reference:
  - mSRGBtoXYZ / mXYZtoSRGB: ScielabProcessor.java:24-33
  - mXYZtoOpp / mOpptoXYZ:   ScielabProcessor.java:34-43 (= OptimizedConvolution.cl:110,118)
  - RGB2Opp (fused linear-RGB -> opponent): OptimizedConvolution.cl:171.
    The Java-side ScielabProcessor.sRGBtoOpp (ScielabProcessor.java:286-290)
    hardcodes a *wrong* second row; the OpenCL constants equal
    mXYZtoOpp @ mSRGBtoXYZ and are what the shipped GPU path used, so we use
    those (here recomputed at double precision then cast to f32).
  - sRGB gamma thresholds 0.04045 / 0.0031308: OptimizedConvolution.cl:85-87,105-107
  - CIELAB f/f_inv breakpoints (delta = 6/29, kappa = 24389/27):
    OptimizedConvolution.cl:120-144, ScielabProcessor.java:356-366
  - Delta-E CIE76: OptimizedConvolution.cl:209 (Euclidean distance in LAB)
  - Delta-E CIE94: OptimizedConvolution.cl:218-226 (graphic-arts constants)
  - CIEDE2000 is declared but left unimplemented in the reference
    (OptimizedConvolution.cl:227-230); implemented here for completeness.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Constants (fp32, exactly the reference's published values)
# ---------------------------------------------------------------------------

#: D65 / D50 whitepoints (ScielabProcessor.java:20-21).
WHITEPOINT_D65 = np.array([0.95047, 1.0, 1.0883], dtype=np.float32)
WHITEPOINT_D50 = np.array([0.966797, 1.0, 0.825188], dtype=np.float32)

WHITEPOINTS = {"D65": WHITEPOINT_D65, "D50": WHITEPOINT_D50}

#: Linear-sRGB -> XYZ (ScielabProcessor.java:24-28).
M_SRGB2XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=np.float32,
)

#: XYZ -> linear-sRGB (ScielabProcessor.java:29-33).
M_XYZ2SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=np.float32,
)

#: XYZ -> opponent (Poirson–Wandell) space (ScielabProcessor.java:34-38).
M_XYZ2OPP = np.array(
    [
        [0.2787336, 0.7218031, -0.1065520],
        [-0.4487736, 0.2898056, -0.0771569],
        [0.0859513, -0.5899859, 0.5011089],
    ],
    dtype=np.float32,
)

#: Opponent -> XYZ, the reference's published (approximate) inverse
#: (ScielabProcessor.java:39-43 = OptimizedConvolution.cl:118).
M_OPP2XYZ = np.array(
    [
        [0.624045, -1.87044, -0.155304],
        [1.36606, 0.931563, 0.433903],
        [1.5013, 1.41761, 2.53307],
    ],
    dtype=np.float32,
)

#: Fused linear-sRGB -> opponent = M_XYZ2OPP @ M_SRGB2XYZ, computed at f64
#: then cast (matches OptimizedConvolution.cl:171 to its printed precision).
M_RGB2OPP = (M_XYZ2OPP.astype(np.float64) @ M_SRGB2XYZ.astype(np.float64)).astype(
    np.float32
)

_LAB_DELTA = 6.0 / 29.0
LAB_DELTA3 = np.float32(_LAB_DELTA**3)  # 216/24389
LAB_KAPPA = np.float32(24389.0 / 27.0)


# ---------------------------------------------------------------------------
# sRGB gamma
# ---------------------------------------------------------------------------

def srgb_to_linear(c):
    """sRGB electro-optical transfer: gamma-expand [0,1] sRGB to linear RGB.

    Mirrors OptimizedConvolution.cl:85-87 (threshold 0.04045, /12.92 vs
    ((v+.055)/1.055)^2.4). The power branch is evaluated on a clamped base so
    negative out-of-gamut inputs don't produce NaN.
    """
    c = jnp.asarray(c)
    safe = jnp.maximum(c, 0.0)
    return jnp.where(
        c <= 0.04045, c / 12.92, jnp.power((safe + 0.055) / 1.055, 2.4)
    )


def linear_to_srgb(c):
    """Inverse sRGB gamma (OptimizedConvolution.cl:105-107)."""
    c = jnp.asarray(c)
    safe = jnp.maximum(c, 1e-12)
    return jnp.where(
        c <= 0.0031308, c * 12.92, 1.055 * jnp.power(safe, 1.0 / 2.4) - 0.055
    )


# ---------------------------------------------------------------------------
# Linear 3x3 transforms (applied as x @ M.T, trailing dim = 3)
# ---------------------------------------------------------------------------

def _apply(M, x):
    # HIGHEST: a bare `@` runs at DEFAULT, which may be TF32 or bf16 on an
    # accelerator. XLA usually lowers a length-3 contraction to f32 FMAs
    # anyway, but that is a lowering choice, not a contract — the parity
    # path never leaves it to chance.
    return jnp.matmul(x, jnp.asarray(M).T, precision=jax.lax.Precision.HIGHEST)


def srgb_to_xyz(srgb):
    """sRGB (gamma) -> XYZ (ScielabProcessor.java:271-277)."""
    return _apply(M_SRGB2XYZ, srgb_to_linear(srgb))


def xyz_to_srgb(xyz):
    """XYZ -> sRGB (gamma) (ScielabProcessor.java:313-321)."""
    return linear_to_srgb(_apply(M_XYZ2SRGB, xyz))


def xyz_to_opp(xyz):
    """XYZ -> opponent (ScielabProcessor.java:323-326)."""
    return _apply(M_XYZ2OPP, xyz)


def opp_to_xyz(opp):
    """Opponent -> XYZ (ScielabProcessor.java:328-331)."""
    return _apply(M_OPP2XYZ, opp)


def srgb_to_opp(srgb):
    """Fused sRGB -> opponent (OptimizedConvolution.cl:172-199 semantics)."""
    return _apply(M_RGB2OPP, srgb_to_linear(srgb))


# ---------------------------------------------------------------------------
# CIELAB
# ---------------------------------------------------------------------------

def lab_f(t):
    """CIELAB f: cbrt above (6/29)^3, linear ramp below.

    Matches OptimizedConvolution.cl:137 — `cbrt(t)` vs `(kappa*t + 16)/116`.
    """
    t = jnp.asarray(t)
    return jnp.where(t > LAB_DELTA3, jnp.cbrt(t), (LAB_KAPPA * t + 16.0) / 116.0)


def lab_finv(t):
    """Inverse of lab_f (ScielabProcessor.java:362-366)."""
    t = jnp.asarray(t)
    d = np.float32(_LAB_DELTA)
    return jnp.where(t > d, t * t * t, 3.0 * d * d * (t - 4.0 / 29.0))


def xyz_to_lab(xyz, whitepoint=WHITEPOINT_D65):
    """XYZ -> CIELAB (ScielabProcessor.java:333-343)."""
    f = lab_f(xyz / jnp.asarray(whitepoint))
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return jnp.stack(
        [116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], axis=-1
    )


def lab_to_xyz(lab, whitepoint=WHITEPOINT_D65):
    """CIELAB -> XYZ (ScielabProcessor.java:345-354)."""
    L = (lab[..., 0] + 16.0) / 116.0
    f = jnp.stack(
        [L + lab[..., 1] / 500.0, L, L - lab[..., 2] / 200.0], axis=-1
    )
    return jnp.asarray(whitepoint) * lab_finv(f)


def opp_to_lab(opp, whitepoint=WHITEPOINT_D65):
    """Opponent -> CIELAB via the reference's Opp2XYZ constants.

    Matches the Opp2LAB device kernel (OptimizedConvolution.cl:124-145).
    """
    return xyz_to_lab(opp_to_xyz(opp), whitepoint)


def srgb_to_lab(srgb, whitepoint=WHITEPOINT_D65):
    """sRGB -> CIELAB (plain, no spatial filtering)."""
    return xyz_to_lab(srgb_to_xyz(srgb), whitepoint)


def lab_to_srgb(lab, whitepoint=WHITEPOINT_D65):
    """CIELAB -> sRGB (ScielabProcessor.java:388-404)."""
    return xyz_to_srgb(lab_to_xyz(lab, whitepoint))


# ---------------------------------------------------------------------------
# Delta-E
# ---------------------------------------------------------------------------

def delta_e76(lab1, lab2):
    """CIE76: Euclidean distance in LAB (OptimizedConvolution.cl:209)."""
    d = lab1 - lab2
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def delta_e94(lab1, lab2):
    """CIE94 with graphic-arts constants (OptimizedConvolution.cl:218-226).

    Like the reference, asymmetric in its arguments (C1 from lab1) and without
    a clamp on the deltaH radicand (the reference computes the raw sqrt).
    """
    L1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    L2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]
    dL = L1 - L2
    c1 = jnp.sqrt(a1 * a1 + b1 * b1)
    dC = c1 - jnp.sqrt(a2 * a2 + b2 * b2)
    da = a1 - a2
    db = b1 - b2
    dH = jnp.sqrt(jnp.maximum(da * da + db * db - dC * dC, 0.0))
    sc = 1.0 + 0.045 * c1
    sh = 1.0 + 0.015 * c1
    return jnp.sqrt(dL * dL + (dC / sc) ** 2 + (dH / sh) ** 2)


def delta_e2000(lab1, lab2):
    """CIEDE2000 (kL = kC = kH = 1).

    The reference plugin declares this variant but never implemented it
    (OptimizedConvolution.cl:227-230); provided here for completeness using
    the standard Sharma et al. formulation.
    """
    L1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    L2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]

    C1 = jnp.sqrt(a1 * a1 + b1 * b1)
    C2 = jnp.sqrt(a2 * a2 + b2 * b2)
    Cbar = 0.5 * (C1 + C2)
    c7 = Cbar**7
    G = 0.5 * (1.0 - jnp.sqrt(c7 / (c7 + 25.0**7)))
    ap1 = (1.0 + G) * a1
    ap2 = (1.0 + G) * a2
    Cp1 = jnp.sqrt(ap1 * ap1 + b1 * b1)
    Cp2 = jnp.sqrt(ap2 * ap2 + b2 * b2)

    hp1 = jnp.where((b1 == 0) & (ap1 == 0), 0.0, jnp.arctan2(b1, ap1))
    hp1 = jnp.where(hp1 < 0, hp1 + 2 * jnp.pi, hp1)
    hp2 = jnp.where((b2 == 0) & (ap2 == 0), 0.0, jnp.arctan2(b2, ap2))
    hp2 = jnp.where(hp2 < 0, hp2 + 2 * jnp.pi, hp2)

    dLp = L2 - L1
    dCp = Cp2 - Cp1
    dhp_raw = hp2 - hp1
    dhp = jnp.where(
        jnp.abs(dhp_raw) <= jnp.pi,
        dhp_raw,
        jnp.where(dhp_raw > jnp.pi, dhp_raw - 2 * jnp.pi, dhp_raw + 2 * jnp.pi),
    )
    dhp = jnp.where(Cp1 * Cp2 == 0.0, 0.0, dhp)
    dHp = 2.0 * jnp.sqrt(Cp1 * Cp2) * jnp.sin(dhp / 2.0)

    Lbp = 0.5 * (L1 + L2)
    Cbp = 0.5 * (Cp1 + Cp2)
    hsum = hp1 + hp2
    habs = jnp.abs(hp1 - hp2)
    hbp = jnp.where(
        Cp1 * Cp2 == 0.0,
        hsum,
        jnp.where(
            habs <= jnp.pi,
            0.5 * hsum,
            jnp.where(hsum < 2 * jnp.pi, 0.5 * (hsum + 2 * jnp.pi), 0.5 * (hsum - 2 * jnp.pi)),
        ),
    )

    T = (
        1.0
        - 0.17 * jnp.cos(hbp - jnp.pi / 6.0)
        + 0.24 * jnp.cos(2.0 * hbp)
        + 0.32 * jnp.cos(3.0 * hbp + jnp.pi / 30.0)
        - 0.20 * jnp.cos(4.0 * hbp - 63.0 * jnp.pi / 180.0)
    )
    dtheta = (30.0 * jnp.pi / 180.0) * jnp.exp(
        -(((hbp * 180.0 / jnp.pi - 275.0) / 25.0) ** 2)
    )
    cbp7 = Cbp**7
    RC = 2.0 * jnp.sqrt(cbp7 / (cbp7 + 25.0**7))
    lterm = (Lbp - 50.0) ** 2
    SL = 1.0 + 0.015 * lterm / jnp.sqrt(20.0 + lterm)
    SC = 1.0 + 0.045 * Cbp
    SH = 1.0 + 0.015 * Cbp * T
    RT = -jnp.sin(2.0 * dtheta) * RC

    return jnp.sqrt(
        (dLp / SL) ** 2
        + (dCp / SC) ** 2
        + (dHp / SH) ** 2
        + RT * (dCp / SC) * (dHp / SH)
    )


DELTA_E_FNS = {
    "CIE76": delta_e76,
    "CIE94": delta_e94,
    "CIEDE2000": delta_e2000,
}


def delta_e(lab1, lab2, kind: str = "CIE76"):
    """Dispatch on the Delta-E formula name (ImageManipulation.java:20 enum)."""
    try:
        return DELTA_E_FNS[kind](lab1, lab2)
    except KeyError:
        raise ValueError(f"unknown deltaE kind {kind!r}; options: {list(DELTA_E_FNS)}")
